"""repro_torch.core — the paper's solvers, in PyTorch.

Communication-avoiding k-step reformulations of stochastic proximal methods
(Soori et al. 2017), all instantiations of one shared s-step core
(``repro_torch.core.sstep``). Classical solvers are its k=1 instantiation.

Solver pairs (classical / CA):
    sfista / ca_sfista   stochastic FISTA           (paper Alg. I / III)
    spnm   / ca_spnm     stochastic proximal Newton (paper Alg. II / IV)
    pdhg   / ca_pdhg     stochastic primal-dual hybrid gradient (1612.04003)
    bcd    / ca_bcd      proximal block coordinate descent      (1612.04003)

Problems (any solver x any problem; BCD runs the dual SVM CoCoA-style):
    LassoProblem, ElasticNetProblem, DualSVMProblem

The distributed forms (one all-reduce per k-block on torch.distributed)
are in :mod:`repro_torch.core.distributed`.
"""
from repro_torch.core.problem import (LassoProblem, ElasticNetProblem,
                                      DualSVMProblem, CoordView,
                                      SolverConfig, lasso_objective,
                                      lipschitz_step)
from repro_torch.core.soft_threshold import (soft_threshold, prox_elem,
                                             moreau_dual_prox,
                                             fista_momentum)
from repro_torch.core.sampling import (sample_columns, sample_index_batch,
                                       sample_indices)
from repro_torch.core.gram import sampled_gram, gram_blocks
from repro_torch.core.fista import sfista
from repro_torch.core.ca_fista import ca_sfista
from repro_torch.core.pnm import spnm
from repro_torch.core.ca_pnm import ca_spnm
from repro_torch.core.pdhg import pdhg, ca_pdhg
from repro_torch.core.bcd import bcd, ca_bcd
from repro_torch.core.distributed import (make_distributed_solver,
                                          shard_problem, CollectiveCount)
from repro_torch.core.cost_model import CostModel, MachineParams
from repro_torch.core.convergence import (relative_solution_error,
                                          solve_reference,
                                          composite_reference)

__all__ = [
    "LassoProblem", "ElasticNetProblem", "DualSVMProblem", "CoordView",
    "SolverConfig", "lasso_objective", "lipschitz_step",
    "soft_threshold", "prox_elem", "moreau_dual_prox", "fista_momentum",
    "sample_columns", "sample_index_batch", "sample_indices",
    "sampled_gram", "gram_blocks",
    "sfista", "ca_sfista", "spnm", "ca_spnm", "pdhg", "ca_pdhg",
    "bcd", "ca_bcd",
    "make_distributed_solver", "shard_problem", "CollectiveCount",
    "CostModel", "MachineParams",
    "relative_solution_error", "solve_reference", "composite_reference",
]

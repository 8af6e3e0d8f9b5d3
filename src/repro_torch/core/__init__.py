"""repro_torch.core — the paper's solvers on Lasso, in PyTorch.

Communication-avoiding k-step reformulations of stochastic proximal methods
(Soori et al. 2017), all instantiations of one shared s-step core
(``repro_torch.core.sstep``). Classical solvers are its k=1 instantiation.

Ported solver pairs (classical / CA):
    sfista / ca_sfista   stochastic FISTA           (paper Alg. I / III)
    spnm   / ca_spnm     stochastic proximal Newton (paper Alg. II / IV)
"""
from repro_torch.core.problem import (LassoProblem, SolverConfig,
                                      lasso_objective, lipschitz_step)
from repro_torch.core.soft_threshold import (soft_threshold, prox_elem,
                                             fista_momentum)
from repro_torch.core.sampling import (sample_columns, sample_index_batch,
                                       sample_indices)
from repro_torch.core.gram import sampled_gram, gram_blocks
from repro_torch.core.fista import sfista
from repro_torch.core.ca_fista import ca_sfista
from repro_torch.core.pnm import spnm
from repro_torch.core.ca_pnm import ca_spnm
from repro_torch.core.cost_model import CostModel, MachineParams
from repro_torch.core.convergence import (relative_solution_error,
                                          solve_reference,
                                          composite_reference)

__all__ = [
    "LassoProblem", "SolverConfig", "lasso_objective", "lipschitz_step",
    "soft_threshold", "prox_elem", "fista_momentum",
    "sample_columns", "sample_index_batch", "sample_indices",
    "sampled_gram", "gram_blocks",
    "sfista", "ca_sfista", "spnm", "ca_spnm",
    "CostModel", "MachineParams",
    "relative_solution_error", "solve_reference", "composite_reference",
]

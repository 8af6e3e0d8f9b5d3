"""Classical SFISTA (paper Algorithm I): the k=1 instantiation of the shared
s-step core (:mod:`repro_torch.core.sstep` + ``FISTA_RULE``)."""
from __future__ import annotations

from repro_torch.core import sstep
from repro_torch.core.problem import SolverConfig


def sfista(problem, cfg: SolverConfig, gen=None, *, idx=None, w0=None,
           collect_history: bool = False, host_loop: bool = False,
           syncs=None):
    """Stochastic FISTA: T iterations, one sampled Gram + update each. In the
    distributed setting each iteration all-reduces (G_j, R_j) — the
    communication the CA variant removes. See :func:`sstep.solve`."""
    return sstep.solve(problem, cfg, gen, sstep.FISTA_RULE, name="sfista",
                       ca=False, idx=idx, w0=w0,
                       collect_history=collect_history, host_loop=host_loop,
                       syncs=syncs)

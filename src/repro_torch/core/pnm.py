"""Classical stochastic proximal Newton method, SPNM (paper Algorithm II):
the k=1 instantiation of the shared s-step core (``sstep.PNM_RULE``)."""
from __future__ import annotations

from repro_torch.core import sstep
from repro_torch.core.problem import SolverConfig


def spnm(problem, cfg: SolverConfig, gen=None, *, idx=None, w0=None,
         collect_history: bool = False, host_loop: bool = False, syncs=None):
    """Stochastic proximal Newton: per iteration, sample a Gram block H_j and
    solve the quadratic subproblem with Q inner ISTA steps (warm-started).
    See :func:`sstep.solve`."""
    return sstep.solve(problem, cfg, gen, sstep.PNM_RULE, name="spnm",
                       ca=False, idx=idx, w0=w0,
                       collect_history=collect_history, host_loop=host_loop,
                       syncs=syncs)

"""CA-SPNM (paper Algorithm IV): k-step communication-avoiding proximal
Newton — ``sstep.PNM_RULE`` under the k-step schedule."""
from __future__ import annotations

from repro_torch.core import sstep
from repro_torch.core.problem import SolverConfig


def ca_spnm(problem, cfg: SolverConfig, gen=None, *, idx=None, w0=None,
            collect_history: bool = False, host_loop: bool = False,
            syncs=None):
    """k-step SPNM: k Gram blocks per batch; each drives a Q-iteration inner
    ISTA solve with no communication. See :func:`sstep.solve`."""
    return sstep.solve(problem, cfg, gen, sstep.PNM_RULE, name="ca_spnm",
                       ca=True, idx=idx, w0=w0,
                       collect_history=collect_history, host_loop=host_loop,
                       syncs=syncs)

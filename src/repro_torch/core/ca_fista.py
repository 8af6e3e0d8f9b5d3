"""CA-SFISTA (paper Algorithm III): the k-step communication-avoiding SFISTA.

Per outer iteration (T/k of them): k Gram blocks G (k, d, d), R (k, d) in
one batch — one collective in the distributed form — then k FISTA updates
with no communication. Given the same draws its arithmetic is that of
classical SFISTA: both are the same ``sstep.solve`` code path.
"""
from __future__ import annotations

from repro_torch.core import sstep
from repro_torch.core.problem import SolverConfig


def ca_sfista(problem, cfg: SolverConfig, gen=None, *, idx=None, w0=None,
              collect_history: bool = False, host_loop: bool = False,
              syncs=None):
    """k-step SFISTA. See :func:`sstep.solve`."""
    return sstep.solve(problem, cfg, gen, sstep.FISTA_RULE, name="ca_sfista",
                       ca=True, idx=idx, w0=w0,
                       collect_history=collect_history, host_loop=host_loop,
                       syncs=syncs)

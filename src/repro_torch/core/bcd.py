"""Stochastic block coordinate descent and its k-step CA form (CA-BCD).

Where SFISTA/SPNM/PDHG sample units (data points) and update the full
iterate, BCD samples coordinates of the iterate and updates only those: the
primal-coordinate s-step method of arXiv 1612.04003 §3. Through
``problem.coord_view()`` the same code runs the primal view (Lasso, elastic
net: coordinates of w, residual v = X^T w - y) and the dual view (SVM:
coordinates of the dual a over samples, the CoCoA-style local-dual framing
of arXiv 1512.04011, with v = Z a).

Per outer block the one collective is the stacked cross-Gram
C = inv_rho * B[U] B[U]^T over the block's k coordinate draws (the ``gram``
op) plus the block gradient g0; the inner k updates replay classical BCD
exactly by correcting each gradient with C_j @ delta (plain tensor code).
At k=1 the correction is identically zero, so ``bcd`` and ``ca_bcd`` are
the same arithmetic with T vs T/k collectives; for k>1 the replay is exact
in real arithmetic and drifts only by float reassociation.
"""
from __future__ import annotations

from repro_torch.core import sstep
from repro_torch.core.problem import SolverConfig


def bcd(problem, cfg: SolverConfig, gen=None, *, idx=None, w0=None,
        collect_history: bool = False, host_loop: bool = False, syncs=None):
    """Stochastic proximal BCD: per iteration, draw a coordinate block of
    size max(b*dim, 1) (without replacement) and take one prox-gradient
    step on those coordinates against the running residual. See
    :func:`sstep.solve`."""
    return sstep.solve(problem, cfg, gen, sstep.BCD_RULE, name="bcd",
                       ca=False, idx=idx, w0=w0,
                       collect_history=collect_history, host_loop=host_loop,
                       syncs=syncs)


def ca_bcd(problem, cfg: SolverConfig, gen=None, *, idx=None, w0=None,
           collect_history: bool = False, host_loop: bool = False,
           syncs=None):
    """k-step BCD: one stacked cross-Gram batch per k coordinate updates
    (arXiv 1612.04003 Alg. 2's s-step recurrence)."""
    return sstep.solve(problem, cfg, gen, sstep.BCD_RULE, name="ca_bcd",
                       ca=True, idx=idx, w0=w0,
                       collect_history=collect_history, host_loop=host_loop,
                       syncs=syncs)

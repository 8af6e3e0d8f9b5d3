"""Stochastic PDHG and its k-step communication-avoiding form (CA-PDHG).

Primal-dual hybrid gradient in the Loris-Verhoeven/PAPC arrangement (K = I)
over the same sampled-Gram statistics as SFISTA: per iteration the primal
takes a plain gradient half-step q = w - t (G_j w - R_j), the dual ascends
through the Moreau-decomposed conjugate prox, and the primal is corrected by
the new dual (``update_rules.pdhg_update``). The update consumes only
(G_j, R_j) and O(dim) state, FISTA's footprint, so the paper's k-step
regrouping of the Gram collective applies verbatim (the s-step primal-dual
method of arXiv 1612.04003 §4 on sampled statistics). A k-block of updates
is one ``pdhg_block`` dispatch.

``sigma`` (dual step) comes from ``SolverConfig.sigma``; default 0.5/t. At
sigma = 1/t and u_0 = 0 each iteration collapses to the ISTA step
prox_{t g}(q), the oracle the tests check.
"""
from __future__ import annotations

from repro_torch.core import sstep
from repro_torch.core.problem import SolverConfig


def pdhg(problem, cfg: SolverConfig, gen=None, *, idx=None, w0=None,
         collect_history: bool = False, host_loop: bool = False, syncs=None):
    """Stochastic PDHG: one sampled Gram pair and primal-dual update per
    iteration. See :func:`sstep.solve`."""
    return sstep.solve(problem, cfg, gen, sstep.PDHG_RULE, name="pdhg",
                       ca=False, idx=idx, w0=w0,
                       collect_history=collect_history, host_loop=host_loop,
                       syncs=syncs)


def ca_pdhg(problem, cfg: SolverConfig, gen=None, *, idx=None, w0=None,
            collect_history: bool = False, host_loop: bool = False,
            syncs=None):
    """k-step PDHG: k Gram pairs per batch, k communication-free
    primal-dual updates; the arithmetic of ``pdhg``, T/k collectives."""
    return sstep.solve(problem, cfg, gen, sstep.PDHG_RULE, name="ca_pdhg",
                       ca=True, idx=idx, w0=w0,
                       collect_history=collect_history, host_loop=host_loop,
                       syncs=syncs)

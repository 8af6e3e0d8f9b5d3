"""Shared per-iteration update rules.

CA and classical solvers call the same functions on (G_j, R_j) — this is
what makes the k-step reformulation arithmetically identical to the
classical algorithm (paper §IV-A). Two routes, bitwise the same:

* the block route, which the solvers take: ``fista_block`` / ``pnm_block``
  run a whole k-block of updates in one dispatch of the kernel registry
  (ops ``prox_step_block`` / ``prox_loop_block``), the classical solvers
  being its k = 1 instance;
* the stepwise route, one update a call: ``fista_update`` / ``pnm_update``
  (ops ``prox_step`` / ``prox_loop``, FISTA's momentum by eager ops), the
  JAX package's rules one for one, which the tests hold the block route to.

The prox scalars ride in the (5,) device tensor ``scal = [t, lam, mu, lo,
hi]`` the solver builds once, and the iteration counter j is a host
integer, so an update reads nothing back from the device.

As in the JAX package, FISTA's gradient is evaluated at the extrapolated
point v_j (Beck & Teboulle 2009); the Gram linearity grad = G v - R makes
this free.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.soft_threshold import fista_momentum
from repro_torch.kernels import registry


class IterState(NamedTuple):
    w_prev: torch.Tensor   # w_{j-2}
    w: torch.Tensor        # w_{j-1}
    j: int                 # iteration counter on the host (starts at 1)


def init_state(w0: torch.Tensor) -> IterState:
    return IterState(w_prev=w0, w=w0, j=1)


def fista_update(G: torch.Tensor, R: torch.Tensor, state: IterState,
                 scal: torch.Tensor, *, variant: str = "l1") -> IterState:
    """One FISTA step with sampled-Gram gradient (paper Alg. III 9-13):

        v   = w + (j-2)/j * (w - w_prev)
        w+  = prox_{t g}( v - t * (G v - R) )
    """
    mom = fista_momentum(state.j)
    v = state.w + mom * (state.w - state.w_prev)
    w_new = registry.dispatch("prox_step", G, R, v, scal, variant=variant)
    return IterState(w_prev=state.w, w=w_new, j=state.j + 1)


def pnm_update(G: torch.Tensor, R: torch.Tensor, state: IterState,
               scal: torch.Tensor, Q: int, *,
               variant: str = "l1") -> IterState:
    """One proximal-Newton step (paper Alg. IV 9-17): Q inner prox-gradient
    iterations z <- prox_{t g}(z - t (G z - R)) warm-started at z_0 = w,
    the subproblem gradient being grad + H(z - w) = G z - R with H = G_j."""
    z = registry.dispatch("prox_loop", G, R, state.w, scal, Q=Q,
                          variant=variant)
    return IterState(w_prev=state.w, w=z, j=state.j + 1)


def _advance(state: IterState, W: torch.Tensor) -> IterState:
    """The state after a block whose k iterates are W (k, d)."""
    k = W.shape[0]
    return IterState(w_prev=W[k - 2] if k > 1 else state.w, w=W[k - 1],
                     j=state.j + k)


def fista_block(G: torch.Tensor, R: torch.Tensor, state: IterState,
                scal: torch.Tensor, *, variant: str = "l1"):
    """k = G.shape[0] FISTA steps in one dispatch, bitwise k calls of
    :func:`fista_update` on (G[i], R[i]). Returns (new state, W (k, d))."""
    W = registry.dispatch("prox_step_block", G, R, state.w_prev, state.w,
                          scal, j0=state.j, variant=variant)
    return _advance(state, W), W


def pnm_block(G: torch.Tensor, R: torch.Tensor, state: IterState,
              scal: torch.Tensor, Q: int, *, variant: str = "l1"):
    """k = G.shape[0] proximal-Newton steps in one dispatch, bitwise k calls
    of :func:`pnm_update` on (G[i], R[i]). Returns (new state, W (k, d))."""
    W = registry.dispatch("prox_loop_block", G, R, state.w, scal, Q=Q,
                          variant=variant)
    return _advance(state, W), W

"""Shared per-iteration update rules.

CA and classical solvers call the same functions on (G_j, R_j) — this is
what makes the k-step reformulation arithmetically identical to the
classical algorithm (paper §IV-A). Two routes, bitwise the same:

* the block route, which the solvers take: ``fista_block`` /
  ``pnm_block`` / ``pdhg_block`` run a whole k-block of updates in one
  dispatch of the kernel registry (ops ``prox_step_block`` /
  ``prox_loop_block`` / ``pdhg_block``, the first two differentiable
  through their recompute backward), the classical solvers being its
  k = 1 instance;
* the stepwise route, one update a call: ``fista_update`` / ``pnm_update``
  / ``pdhg_update`` (ops ``prox_step`` / ``prox_loop``, FISTA's momentum
  and PDHG's dual step by eager ops), the JAX package's rules one for one,
  which the tests hold the block route to.

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

from repro_torch.core.soft_threshold import fista_momentum, moreau_dual_prox
from repro_torch.kernels import registry
from repro_torch.kernels.prox_step import ops as prox_ops


class IterState(NamedTuple):
    w_prev: torch.Tensor   # w_{j-2}
    w: torch.Tensor        # w_{j-1}
    j: int                 # iteration counter on the host (starts at 1)


def init_state(w0: torch.Tensor) -> IterState:
    return IterState(w_prev=w0, w=w0, j=1)


class PdhgState(NamedTuple):
    w: torch.Tensor        # primal iterate
    u: torch.Tensor        # dual iterate (in the prox-conjugate's domain)
    j: int


def init_pdhg_state(w0: torch.Tensor) -> PdhgState:
    return PdhgState(w=w0, u=torch.zeros_like(w0), j=1)


def pdhg_sigma(cfg_sigma, t: torch.Tensor) -> torch.Tensor:
    """PDHG's dual step as a (1,) device tensor: ``cfg_sigma`` when set,
    else 0.5 / t computed on the device (nothing read back)."""
    if cfg_sigma is not None:
        return torch.full((1,), cfg_sigma, dtype=torch.float32,
                          device=t.device)
    return (0.5 / t).reshape(1).to(torch.float32)


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


def pdhg_update(G: torch.Tensor, R: torch.Tensor, state: PdhgState,
                scal: torch.Tensor, sigma: torch.Tensor, *,
                variant: str = "l1") -> PdhgState:
    """One s-step PDHG iteration (Loris-Verhoeven / PAPC form, K = I):

        q    = w - t * (G w - R)                   # gradient half-step
        wbar = q - t * u                           # primal extrapolation
        u+   = prox_{sigma g*}(u + sigma * wbar)   # dual ascent (Moreau)
        w+   = q - t * u+

    With sigma = 1/t this collapses to the proximal-gradient (ISTA) step
    prox_{t g}(q). The gradient half-step is the ``prox_step`` op at
    variant "none", as in the JAX package."""
    t, lam, mu, lo, hi = scal.unbind()
    sig = sigma.reshape(())
    q = registry.dispatch("prox_step", G, R, state.w, scal, variant="none")
    wbar = q - t * state.u
    u_new = moreau_dual_prox(state.u + sig * wbar, sig, variant=variant,
                             lam=lam, mu=mu, lo=lo, hi=hi)
    return PdhgState(w=q - t * u_new, u=u_new, j=state.j + 1)


def _advance(state: IterState, W: torch.Tensor) -> IterState:
    """The state after a block whose k iterates are W (k, d)."""
    k = W.shape[0]
    return IterState(w_prev=W[k - 2] if k > 1 else state.w, w=W[k - 1],
                     j=state.j + k)


def fista_block(G: torch.Tensor, R: torch.Tensor, state: IterState,
                scal: torch.Tensor, *, variant: str = "l1"):
    """k = G.shape[0] FISTA steps in one dispatch, bitwise k calls of
    :func:`fista_update` on (G[i], R[i]). Returns (new state, W (k, d))."""
    W = prox_ops.prox_step_block(G, R, state.w_prev, state.w, scal,
                                 j0=state.j, variant=variant)
    return _advance(state, W), W


def pnm_block(G: torch.Tensor, R: torch.Tensor, state: IterState,
              scal: torch.Tensor, Q: int, *, variant: str = "l1"):
    """k = G.shape[0] proximal-Newton steps in one dispatch, bitwise k calls
    of :func:`pnm_update` on (G[i], R[i]). Returns (new state, W (k, d))."""
    W = prox_ops.prox_loop_block(G, R, state.w, scal, Q=Q, variant=variant)
    return _advance(state, W), W


def pdhg_block(G: torch.Tensor, R: torch.Tensor, state: PdhgState,
               scal: torch.Tensor, sigma: torch.Tensor, *,
               variant: str = "l1"):
    """k = G.shape[0] PDHG steps in one dispatch, k calls of
    :func:`pdhg_update` on (G[i], R[i]). Returns (new state, W (k, d))."""
    W, u = registry.dispatch("pdhg_block", G, R, state.w, state.u, scal,
                             sigma, variant=variant)
    return PdhgState(w=W[-1], u=u, j=state.j + G.shape[0]), W

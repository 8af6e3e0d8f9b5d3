"""Plain PyTorch versions of the fused prox kernels: the CPU path and the
oracle the CUDA kernels are held against.

``scal`` is the (5,) float32 tensor ``[t, lam, mu, lo, hi]``; ``variant``
selects the element-wise prox (``l1``, ``elastic_net``, ``box``, ``none``),
as in ``repro.kernels.prox_step.ref``. No value is read back to the host.
The block versions loop the one-step versions k times (PDHG's,
:func:`pdhg_step`, is the JAX package's ``pdhg_update`` op for op), with
FISTA's momentum from :func:`fista_momentum` (kept here, below the solvers that
re-export it, so the kernels import nothing of ``core``).
"""
import numpy as np
import torch

VARIANTS = ("l1", "elastic_net", "box", "none")


def _shrink(x, thresh):
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - thresh, 0.0)


def prox(x: torch.Tensor, scal: torch.Tensor, variant: str,
         step=None) -> torch.Tensor:
    """The element-wise prox of g at step ``step`` (default t, scal[0])."""
    t, lam, mu, lo, hi = scal.unbind()
    if step is not None:
        t = step
    if variant == "l1":
        return _shrink(x, lam * t)
    if variant == "elastic_net":
        return _shrink(x, lam * t) / (1.0 + mu * t)
    if variant == "box":
        return torch.clamp(x, min=lo, max=hi)
    if variant == "none":
        return x
    raise ValueError(f"unknown prox variant {variant!r}; expected one of "
                     f"{VARIANTS}")


def prox_step(G, R, v, scal, *, variant="l1"):
    """w+ = prox(v - t (G v - R)): one fused composite-gradient update."""
    return prox(v - scal[0] * (G @ v - R), scal, variant)


def prox_loop(G, R, z0, scal, *, Q: int, variant="l1"):
    """Q warm-started proximal-gradient iterations on the proximal-Newton
    subproblem (paper Alg. IV lines 13-16)."""
    z = z0
    for _ in range(Q):
        z = prox(z - scal[0] * (G @ z - R), scal, variant)
    return z


def fista_momentum(j: int) -> float:
    """Paper's momentum coefficient (j-2)/j (eq. 9), zero-clamped for j < 2.

    ``j`` is the host iteration counter, so no device value is read. The
    arithmetic is float32, as in the JAX package; the result is returned as
    a Python float holding that float32 value exactly.
    """
    jf = np.float32(j)
    return float(max((jf - np.float32(2.0)) / max(jf, np.float32(1.0)),
                     np.float32(0.0)))


def prox_step_block(G, R, w_prev, w, scal, *, j0: int, variant="l1"):
    """k FISTA steps against G (k, d, d), R (k, d): step i extrapolates
    v = w + mom(j0 + i) (w - w_prev), then w_prev, w = w, prox_step(v).
    Returns the k iterates W (k, d)."""
    out = []
    for i in range(G.shape[0]):
        mom = fista_momentum(j0 + i)
        v = w + mom * (w - w_prev)
        w_prev, w = w, prox_step(G[i], R[i], v, scal, variant=variant)
        out.append(w)
    return torch.stack(out)


def prox_loop_block(G, R, z0, scal, *, Q: int, variant="l1"):
    """k proximal Newton steps against G (k, d, d), R (k, d), each Q
    warm-started iterations from the previous step's result. Returns the k
    iterates W (k, d)."""
    out = []
    z = z0
    for i in range(G.shape[0]):
        z = prox_loop(G[i], R[i], z, scal, Q=Q, variant=variant)
        out.append(z)
    return torch.stack(out)


def pdhg_step(G, R, w, u, scal, sigma, *, variant="l1"):
    """One PDHG step (the Loris-Verhoeven form, K = I), op for op the JAX
    package's ``pdhg_update``: q = w - t (G w - R), wbar = q - t u,
    u+ = x - sigma prox_{g/sigma}(x / sigma) with x = u + sigma wbar (the
    Moreau identity), w+ = q - t u+. Returns (w+, u+)."""
    t, sigma = scal[0], sigma.reshape(())
    q = prox_step(G, R, w, scal, variant="none")
    wbar = q - t * u
    x = u + sigma * wbar
    inv = 1.0 / sigma
    u_new = x - sigma * prox(x * inv, scal, variant, step=inv)
    return q - t * u_new, u_new


def pdhg_block(G, R, w, u, scal, sigma, *, variant="l1"):
    """k PDHG steps against G (k, d, d), R (k, d): k calls of
    :func:`pdhg_step`. Returns the k primal iterates W (k, d) and the last
    dual iterate u."""
    out = []
    for i in range(G.shape[0]):
        w, u = pdhg_step(G[i], R[i], w, u, scal, sigma, variant=variant)
        out.append(w)
    return torch.stack(out), u

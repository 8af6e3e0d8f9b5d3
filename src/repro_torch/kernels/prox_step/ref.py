"""Plain PyTorch versions of the fused prox kernels: the CPU path and the
oracle the CUDA kernels are held against.

``scal`` is the (5,) float32 tensor ``[t, lam, mu, lo, hi]``; ``variant``
selects the element-wise prox (``l1``, ``elastic_net``, ``box``, ``none``),
as in ``repro.kernels.prox_step.ref``. No value is read back to the host.
"""
import torch

VARIANTS = ("l1", "elastic_net", "box", "none")


def _shrink(x, thresh):
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - thresh, 0.0)


def prox(x: torch.Tensor, scal: torch.Tensor, variant: str) -> torch.Tensor:
    t, lam, mu, lo, hi = scal.unbind()
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

"""Soft-thresholding operator S_lambda — the prox of lambda*||.||_1 (paper
eq. 7) — the element-wise prox family, its Moreau dual, and FISTA's
momentum."""
from __future__ import annotations

import torch

# FISTA's momentum lives with the prox kernels, which compute it too
from repro_torch.kernels.prox_step.ref import fista_momentum  # noqa: F401


def soft_threshold(w: torch.Tensor, thresh) -> torch.Tensor:
    """[S_lam(w)]_i = sign(w_i) * max(|w_i| - lam, 0), elementwise."""
    return torch.sign(w) * torch.clamp_min(torch.abs(w) - thresh, 0.0)


def prox_elem(x: torch.Tensor, step, variant: str = "l1", lam=0.0, mu=0.0,
              lo=0.0, hi=0.0) -> torch.Tensor:
    """Element-wise prox of the composite penalty g at step size ``step``:

      l1           g = lam||.||_1                 S_{lam*step}(x)
      elastic_net  g = lam||.||_1 + (mu/2)||.||^2 S_{lam*step}(x)/(1+mu*step)
      box          g = indicator of [lo, hi]      clip(x, lo, hi)
      none         g = 0                          x
    """
    if variant == "l1":
        return soft_threshold(x, lam * step)
    if variant == "elastic_net":
        return soft_threshold(x, lam * step) / (1.0 + mu * step)
    if variant == "box":
        return torch.clamp(x, lo, hi)
    if variant == "none":
        return x
    raise ValueError(f"unknown prox variant {variant!r}; expected one of "
                     "('l1', 'elastic_net', 'box', 'none')")


def moreau_dual_prox(x: torch.Tensor, sigma, variant: str = "l1", lam=0.0,
                     mu=0.0, lo=0.0, hi=0.0) -> torch.Tensor:
    """prox of sigma*g^* via the Moreau identity:
    prox_{sigma g*}(x) = x - sigma * prox_{g/sigma}(x/sigma). Used by the
    PDHG dual ascent step for every prox variant above."""
    inv = 1.0 / sigma
    return x - sigma * prox_elem(x * inv, inv, variant=variant, lam=lam,
                                 mu=mu, lo=lo, hi=hi)

"""Soft-thresholding operator S_lambda — the prox of lambda*||.||_1 (paper
eq. 7) — the element-wise prox family, and FISTA's momentum."""
from __future__ import annotations

import numpy as np
import torch


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


def fista_momentum(j: int) -> float:
    """Paper's momentum coefficient (j-2)/j (eq. 9), zero-clamped for j < 2.

    ``j`` is the host iteration counter, so no device value is read. The
    arithmetic is float32, as in the JAX package; the result is returned as
    a Python float holding that float32 value exactly.
    """
    jf = np.float32(j)
    return float(max((jf - np.float32(2.0)) / max(jf, np.float32(1.0)),
                     np.float32(0.0)))

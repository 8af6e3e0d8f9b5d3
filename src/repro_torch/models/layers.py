"""Shared layers: RMSNorm, rotary embeddings (M-RoPE too), initializers
(the counterpart of ``repro.models.layers``; its ``layer_norm`` is used by
no model and is not ported).

The bf16 rounding points are the JAX package's: RMSNorm takes float32
statistics and applies in the stream dtype, RoPE rotates in float32 and
rounds once to the input dtype.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.models import tp


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with float32 statistics and application in x's dtype:
    ``x * rsqrt(mean(x^2) + eps).astype(x.dtype) * gamma.astype(x.dtype)``,
    two products each rounded to x's dtype, as in JAX. A gain split over
    the model axis is gathered first (``models.tp``)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * tp.replicate(gamma).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 1e4,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 1e4):
    """(cos, sin) of the rotary angles, float32, shaped (..., S, 1, Dh/2) to
    broadcast over heads. A step computes them once and every layer's q and
    k reuse them (JAX recomputes them per use and XLA fuses the work; here
    each recomputation would be launches of its own)."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    ang = positions[..., None].float() * freqs                # (..., S, dh/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def mrope_tables(positions_3d: torch.Tensor, head_dim: int,
                 theta: float = 1e4, sections: Sequence[int] = (2, 1, 1)):
    """Qwen2-VL M-RoPE as :func:`rope_tables`' (cos, sin) pair: the rotary
    spectrum is split into (t, h, w) sections (ratios ``sections``) and each
    frequency takes its angle from its section's position stream
    (``positions_3d`` (3, ..., S)). The bounds are ``repro.models.layers
    .apply_mrope``'s, the last section absorbing the rounding, so
    ``apply_rope(x, None, tables=...)`` rotates as ``apply_mrope`` does."""
    half = head_dim // 2
    total = sum(sections)
    bounds, start = [], 0
    for s in sections:
        size = half * s // total
        bounds.append((start, start + size))
        start += size
    bounds[-1] = (bounds[-1][0], half)                  # absorb rounding
    freqs = rope_freqs(head_dim, theta, device=positions_3d.device)
    ang = torch.cat([pos[..., None].float() * freqs[lo:hi]
                     for (lo, hi), pos in zip(bounds, positions_3d)], dim=-1)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: Optional[torch.Tensor],
               theta: float = 1e4, tables=None) -> torch.Tensor:
    """x (..., S, H, Dh); positions (..., S) integer, or ``tables`` from
    :func:`rope_tables`. Rotates the (even, odd) lane pairs in float32 and
    rounds to x's dtype."""
    if tables is None:
        tables = rope_tables(positions, x.shape[-1], theta)
    cos, sin = tables
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def dense_init(gen: torch.Generator, shape: Sequence[int], in_axis: int = 0,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn from ``gen`` (in float32, then cast
    to ``dtype``). ``torch.Generator`` gives other numbers than
    ``jax.random`` from the same seed: parity tests carry the JAX weights
    across with :func:`repro_torch.models.convert.params_from_numpy`."""
    fan_in = shape[in_axis]
    w = torch.randn(*shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * fan_in ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    w = torch.randn(vocab, d, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * d ** -0.5).to(dtype)

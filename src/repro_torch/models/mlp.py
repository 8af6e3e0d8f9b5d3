"""Feed-forward block: SwiGLU (the counterpart of ``repro.models.mlp``; the
whisper GeLU MLP comes with the audio family)."""
from __future__ import annotations

import torch

from repro_torch.models.layers import dense_init


def init_swiglu(gen: torch.Generator, d: int, ff: int, dtype=torch.float32,
                device=None) -> dict:
    return dict(
        w_gate=dense_init(gen, (d, ff), dtype=dtype, device=device),
        w_up=dense_init(gen, (d, ff), dtype=dtype, device=device),
        w_down=dense_init(gen, (ff, d), dtype=dtype, device=device),
    )


def silu(h: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` with its rounding points: XLA expands it to
    h * 1/(1 + exp(-h)) and rounds every op to the stream dtype, where
    ``F.silu`` rounds once; the two differ in half the bf16 outputs."""
    return h * torch.reciprocal(1 + torch.exp(-h))


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B,S,d) -> (B,S,d); weights cast to x's dtype first, as in JAX."""
    h = x @ params["w_gate"].to(x.dtype)
    u = x @ params["w_up"].to(x.dtype)
    return (silu(h) * u) @ params["w_down"].to(x.dtype)

"""Feed-forward blocks: SwiGLU (llama family) and GeLU (whisper), the
counterpart of ``repro.models.mlp``."""
from __future__ import annotations

import math

import torch

from repro_torch.models import tp
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
    ``F.silu`` rounds once; the two differ in half the bf16 outputs. Its
    backward is autograd's of these ops: JAX's own rule, g s + (h g)
    s (1 - s), moves one mamba2 update past the train test's limit
    (ROADMAP queue 3 item 6)."""
    return h * torch.reciprocal(1 + torch.exp(-h))


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B,S,d) -> (B,S,d); weights cast to x's dtype first, as in JAX.
    Under tensor parallelism the products follow the weights' split and
    the output is replicated (``models.tp``)."""
    h = tp.matmul(x, params["w_gate"].to(x.dtype))
    u = tp.matmul(x, params["w_up"].to(x.dtype))
    return tp.replicate(tp.matmul(silu(h) * u,
                                  params["w_down"].to(x.dtype)))


def init_gelu_mlp(gen: torch.Generator, d: int, ff: int, dtype=torch.float32,
                  device=None) -> dict:
    return dict(
        w_in=dense_init(gen, (d, ff), dtype=dtype, device=device),
        b_in=torch.zeros(ff, dtype=dtype, device=device),
        w_out=dense_init(gen, (ff, d), dtype=dtype, device=device),
        b_out=torch.zeros(d, dtype=dtype, device=device),
    )


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default, the tanh form) with its rounding
    points: x * 0.5 (1 + tanh(c (x + 0.044715 x^3))), c = sqrt(2/pi), both
    constants in x's dtype and every op rounded to it, as XLA runs it.
    ``F.gelu(approximate="tanh")`` rounds once: in bf16 it differs from
    this in 42.55% of the outputs over 2^20 inputs drawn N(0, 9), where
    this matches JAX's bits in all of them, on the CPU
    (``tests/test_torch_families.py``)."""
    c, k = _GELU_CONSTANTS[x.dtype]
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


#: gelu's two constants rounded to each float dtype (through float32, as
#: JAX casts them), as host floats: a scalar tensor on the card would be a
#: host-to-device copy, a sync, in every decode step. Made at import, so no
#: sync audit sees the reads.
_GELU_CONSTANTS = {
    dt: tuple(float(torch.tensor(v, dtype=torch.float32).to(dt))
              for v in (math.sqrt(2 / math.pi), 0.044715))
    for dt in (torch.float32, torch.bfloat16, torch.float16)}


def gelu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B,S,d) -> (B,S,d): GeLU between two biased projections, weights
    and biases cast to x's dtype first, as in JAX."""
    h = x @ params["w_in"].to(x.dtype) + params["b_in"].to(x.dtype)
    return gelu(h) @ params["w_out"].to(x.dtype) + params["b_out"].to(x.dtype)

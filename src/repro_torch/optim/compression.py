"""Gradient compression for the k-boundary sync (bandwidth-bound regimes),
the counterpart of ``repro.optim.compression``.

The paper shows latency drops k-fold while bandwidth is unchanged: at large
P the k-step algorithms become bandwidth-bound. These compressors attack
that regime for the LM-training analogue, the delta all-reduce at the CA
sync boundary. Both return the residual, for error feedback.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Compressed(NamedTuple):
    values: torch.Tensor
    indices: torch.Tensor       # top-k only; empty for int8
    scale: torch.Tensor


def topk_compress(g: torch.Tensor, frac: float = 0.01):
    """Keep the largest-|.| ``frac`` of the entries. Returns (compressed,
    residual). Ties in |.| keep the lower index first, as ``lax.top_k``
    orders them (a stable descending sort)."""
    flat = g.reshape(-1)
    k = max(int(flat.numel() * frac), 1)
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    kept = flat[idx]
    resid = flat.clone()
    resid[idx] = 0
    return Compressed(values=kept, indices=idx.to(torch.int32),
                      scale=torch.ones((), dtype=g.dtype, device=g.device)), \
        resid.reshape(g.shape)


def topk_decompress(c: Compressed, shape) -> torch.Tensor:
    flat = torch.zeros(math.prod(shape), dtype=c.values.dtype,
                       device=c.values.device)
    flat[c.indices.long()] = c.values * c.scale
    return flat.reshape(shape)


def int8_compress(g: torch.Tensor):
    """Symmetric per-tensor int8 quantization. Returns (compressed,
    residual)."""
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.to(g.dtype) * scale
    return Compressed(values=q, indices=torch.zeros(0, dtype=torch.int32,
                                                    device=g.device),
                      scale=scale), g - deq


def int8_decompress(c: Compressed, shape) -> torch.Tensor:
    return (c.values.to(torch.float32) * c.scale).reshape(shape)

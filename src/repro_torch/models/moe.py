"""Mixture-of-Experts FFN (the counterpart of ``repro.models.moe``):
token-choice top-k routing with capacity dropping, shared experts
(DeepSeek-MoE style).

Each batch row is a routing group. Dispatch scatters the kept tokens into
an expert buffer of C slots per expert and row, the experts run a SwiGLU
over the buffer as three batched products, and the combine gathers each
token's slots back, weighted. The buffer is laid out (E, B, C, d), where
JAX's is (B, E, C, d): each expert's products then contract over all of
its (B, C) rows in one GEMM, forward and backward, as XLA's ``dot_general``
does. Over JAX's layout torch's broadcast product would sum the weights'
grads over B after rounding each row's to bf16, a rounding JAX does not
make. The router runs in float32; everything else in the stream dtype,
with the JAX package's rounding points.

The expert products are plain large products that the JAX package also
computes outside any Pallas kernel; no kernel of the port runs here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.models.mlp import init_swiglu, silu, swiglu

#: the leaves the block reads in float32 (the router), kept in float32 in a
#: bf16 tree, as ``models.ssm.FLOAT32_LEAVES``
FLOAT32_LEAVES = ("router",)


def init_moe(gen: torch.Generator, d: int, moe_ff: int, n_experts: int,
             n_shared: int, shared_ff: int, dtype=torch.float32,
             device=None) -> dict:
    """Random weights from ``gen``, drawn as ``repro.models.moe.init_moe``
    draws them (other numbers than ``jax.random``): the router N(0, 1/d),
    kept in float32 whatever ``dtype``; stacked experts (E, d, ff) and
    (E, ff, d), N(0, 1/fan_in); a shared SwiGLU of width ``shared_ff`` when
    ``n_shared``."""
    params = dict(
        router=dense_init(gen, (d, n_experts), dtype=torch.float32,
                          device=device),
        w_gate=dense_init(gen, (n_experts, d, moe_ff), in_axis=1,
                          dtype=dtype, device=device),
        w_up=dense_init(gen, (n_experts, d, moe_ff), in_axis=1, dtype=dtype,
                        device=device),
        w_down=dense_init(gen, (n_experts, moe_ff, d), in_axis=1,
                          dtype=dtype, device=device),
    )
    if n_shared:
        params["shared"] = init_swiglu(gen, d, shared_ff, dtype, device)
    return params


def _slots(ye: torch.Tensor, sel: torch.Tensor, pos: torch.Tensor):
    """ye[sel[b, s, j], b, pos[b, s, j]] of ye (E, B, C, d): (B, S, k,
    d)."""
    b = torch.arange(ye.shape[1], device=ye.device)[:, None, None]
    return ye[sel, b, pos]


class Combine(torch.autograd.Function):
    """``_combine``: out[b, s] = sum_j w[b, s, j] ye[sel[b, s, j], b,
    pos[b, s, j]] (ye (E, B, C, d)), with JAX's custom VJP (``_combine_bwd``) as the
    backward: g_ye a scatter-add of dout·w into ye's (e, c) slots, g_w the
    inner product of each gathered slot with dout.

    Every (e, c) slot holds at most one kept token; the dropped ones point
    at slot C - 1 with w = 0, so everything else added there is an exact
    zero. The scatter-add (``index_put_`` with ``accumulate=True``) thus
    gives the same bits in any order, on either device."""

    @staticmethod
    def forward(ctx, ye, sel, pos, w):
        ctx.save_for_backward(ye, sel, pos, w)
        # the k-term sum in float32, rounded once, as XLA sums the bf16
        # einsum; the same bits on either device
        g = _slots(ye, sel, pos)                              # (B, S, k, d)
        return (g.float() * w.float()[..., None]).sum(2).to(ye.dtype)

    @staticmethod
    def backward(ctx, dout):
        ye, sel, pos, w = ctx.saved_tensors
        upd = dout[:, :, None, :] * w[..., None]             # (B, S, k, d)
        b = torch.arange(ye.shape[1], device=ye.device)[:, None, None]
        g_ye = torch.zeros(ye.shape, dtype=dout.dtype, device=ye.device)
        g_ye.index_put_((sel, b.expand_as(sel), pos), upd, accumulate=True)
        g_w = (_slots(ye, sel, pos) @ dout[..., None])[..., 0]
        return g_ye, None, None, g_w


def sorted_top_k(gates: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, ties broken
    toward the lower index (``torch.topk`` promises no order among equal
    values; a stable descending sort does)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params: dict, x: torch.Tensor, *, top_k: int,
          capacity_factor: float = 1.25):
    """The router's decisions: (gates (B,S,E) float32, renormalized
    weights (B,S,k), sel (B,S,k), each slot's position in its expert's
    buffer (B,S,k), keep (B,S,k), C)."""
    B, S, d = x.shape
    E = params["router"].shape[1]
    C = max(int(S * top_k / E * capacity_factor), 4)      # slots a row
    logits = x.float() @ params["router"].float()
    gates = torch.softmax(logits, dim=-1)
    weights, sel = sorted_top_k(gates, top_k)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    # each (token, slot)'s position in its expert's buffer: the count of
    # earlier slots routed there over the (S * k) axis, in JAX's order
    flat = F.one_hot(sel, E).reshape(B, S * top_k, E)
    pos = flat.cumsum(1) - flat
    pos_tok = (pos * flat).sum(-1).reshape(B, S, top_k)
    keep = pos_tok < C
    return gates, weights, sel, pos_tok, keep, C


def moe_ffn(params: dict, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25):
    """x (B, S, d) -> (out (B, S, d), the GShard load-balance aux loss).

    Capacity C = max(int(S top_k / E cf), 4) a batch row. Tokens over
    capacity are dropped: their slots add nothing (they fall back to the
    shared experts and the residual)."""
    B, S, d = x.shape
    E = params["router"].shape[1]
    gates, weights, sel, pos_tok, keep, C = route(
        params, x, top_k=top_k, capacity_factor=capacity_factor)
    pos_clip = torch.where(keep, pos_tok, C - 1)          # drops collide
    src = torch.where(keep[..., None], x[:, :, None, :],
                      torch.zeros((), dtype=x.dtype, device=x.device))
    # dispatch: each (e, c) slot gets at most one kept token and exact
    # zeros from the dropped ones, so the accumulation order changes no bit
    b = torch.arange(B, device=x.device)[:, None, None].expand_as(sel)
    buf = torch.zeros(E, B * C, d, dtype=x.dtype, device=x.device)
    buf = buf.view(E, B, C, d).index_put((sel, b, pos_clip), src,
                                         accumulate=True)

    wg, wu, wd = (params[n].to(x.dtype) for n in ("w_gate", "w_up",
                                                   "w_down"))
    rows = buf.view(E, B * C, d)
    h = silu(rows @ wg) * (rows @ wu)                     # (E, B C, ff)
    ye = (h @ wd).view(E, B, C, d)

    wk = torch.where(keep, weights, torch.zeros((), device=x.device)).to(
        x.dtype)
    out = Combine.apply(ye, sel, pos_clip, wk)
    if "shared" in params:
        out = out + swiglu(params["shared"], x)

    # GShard load-balance aux loss: E * sum_e f_e * p_e
    frac = F.one_hot(sel, E).sum(2).reshape(B * S, E).float().mean(0)
    prob = gates.reshape(B * S, E).mean(0)
    return out, E * (frac * prob).sum()

"""Plain PyTorch versions of the two attention kernels: the CPU path and the
oracle each CUDA kernel is held against on the card.

Both compute the Pallas kernels' arithmetic (``repro.kernels.flash_attention
.kernel``): inputs upcast to float32, scores, softmax and p·v in float32,
the result cast to q's dtype. Masked positions weigh exactly 0, and a row
that sees no key at all gives 0 (the kernels' ``acc / max(l, 1e-30)``).
Layouts are the model's: q (B, S, Hq, D), k/v (B, Skv, Hkv, D).
"""
from __future__ import annotations

from typing import Optional

import torch


def _softmax_pv(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(s) @ v over the last axis of s, in float32, with -inf entries
    at exactly 0 weight and all-masked rows giving 0."""
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return (p @ v) / l.clamp_min(1e-30)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention with materialized scores. q (B,Sq,Hq,D), k/v
    (B,Skv,Hkv,D), Hq % Hkv == 0 -> (B,Sq,Hq,D) in q's dtype. The causal
    mask is right-aligned: query i sees keys [0, Skv - Sq + i]."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    qg = q.float().reshape(B, Sq, Hkv, group, D).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3).unsqueeze(2)       # (B,Hkv,1,Skv,D)
    vf = v.float().permute(0, 2, 1, 3).unsqueeze(2)
    s = (qg @ kf.transpose(-1, -2)) * scale               # (B,Hkv,G,Sq,Skv)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        kpos = torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    o = _softmax_pv(s, vf)                                # (B,Hkv,G,Sq,D)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 page_table: torch.Tensor, kv_valid_len, *,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Single-query decode attention through a page table. q (B,1,Hq,D);
    pools (num_pages, page_size, Hkv, D) of float32, bf16 or int8 (then
    ``k_scale``/``v_scale`` (num_pages, page_size, Hkv) float32, dequantized
    as code * scale); page_table (B, npages) int; kv_valid_len scalar or (B,)
    -> (B,1,Hq,D) in q's dtype. Positions at or past a row's valid length
    (table entries 0, the scratch page, among them) weigh exactly 0."""
    B, S, Hq, D = q.shape
    if S != 1:
        raise ValueError(f"paged decode expects a single query, got S={S}")
    P, Hkv = k_pool.shape[1], k_pool.shape[2]
    group = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    table = page_table.long()
    k = k_pool[table].float().reshape(B, -1, Hkv, D)      # (B, npages*P, ..)
    v = v_pool[table].float().reshape(B, -1, Hkv, D)
    if k_scale is not None:
        k = k * k_scale[table].reshape(B, -1, Hkv)[..., None]
        v = v * v_scale[table].reshape(B, -1, Hkv)[..., None]
    valid = torch.as_tensor(kv_valid_len, device=q.device).reshape(-1)
    valid = valid.expand(B).reshape(B, 1, 1, 1, 1)
    qg = q.float().reshape(B, Hkv, group, 1, D)
    kf = k.permute(0, 2, 1, 3).unsqueeze(2)               # (B,Hkv,1,T,D)
    vf = v.permute(0, 2, 1, 3).unsqueeze(2)
    s = (qg @ kf.transpose(-1, -2)) * scale               # (B,Hkv,G,1,T)
    pos = torch.arange(s.shape[-1], device=q.device)
    s = s.masked_fill(pos >= valid, float("-inf"))
    o = _softmax_pv(s, vf)                                # (B,Hkv,G,1,D)
    return o.reshape(B, 1, Hq, D).to(q.dtype)

"""Plain PyTorch versions of the attention kernels: the CPU path and the
oracle each CUDA kernel is held against on the card.

The forwards compute the Pallas kernels' arithmetic (``repro.kernels
.flash_attention.kernel``): inputs upcast to float32, scores, softmax and
p·v in float32, the result cast to q's dtype. Masked positions weigh
exactly 0, and a row that sees no key at all gives 0 (the kernels'
``acc / max(l, 1e-30)``) and has lse = -inf. The backward versions
(:func:`flash_dq`, :func:`flash_dkv`) are the FA-2 equations of
``repro.kernels.flash_attention.backward`` on materialized float32 scores,
with p = exp(s - lse) on visible entries and 0 elsewhere.
Layouts are the model's: q (B, S, Hq, D), k/v (B, Skv, Hkv, D); lse and
delta are (B, Hq, Sq) float32.
"""
from __future__ import annotations

from typing import Optional

import torch


def _softmax_pv(s: torch.Tensor, v: torch.Tensor,
                round_p: bool = False) -> torch.Tensor:
    """softmax(s) @ v over the last axis of s, in float32, with -inf entries
    at exactly 0 weight and all-masked rows giving 0. With ``round_p`` p is
    rounded once to bf16 before the product; l still sums the float32 p."""
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if round_p:
        p = p.bfloat16().float()
    return (p @ v) / l.clamp_min(1e-30)


def _visible(Sq: int, Skv: int, causal: bool, device) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query sees. The causal mask is
    right-aligned: query i sees keys [0, Skv - Sq + i]."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=device)[None, :]
    return (kpos <= qpos) if causal else torch.ones(
        Sq, Skv, dtype=torch.bool, device=device)


def _scores(q, k, causal: bool, scale: float):
    """Scaled float32 scores (B, Hkv, G, Sq, Skv), -inf where masked, and
    the mask."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3).unsqueeze(2)       # (B,Hkv,1,Skv,D)
    s = (qg @ kf.transpose(-1, -2)) * scale
    vis = _visible(Sq, Skv, causal, q.device)
    return s.masked_fill(~vis, float("-inf")), vis


def _heads_last(x: torch.Tensor) -> torch.Tensor:
    """(B, Hkv, G, S, D) -> (B, S, Hkv * G, D)."""
    B, Hkv, G, S, D = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(B, S, Hkv * G, D)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    return_lse: bool = False):
    """GQA attention with materialized scores. q (B,Sq,Hq,D), k/v
    (B,Skv,Hkv,D), Hq % Hkv == 0 -> (B,Sq,Hq,D) in q's dtype, and with
    ``return_lse`` also the lse (see :func:`flash_attention_lse`). The
    causal mask is right-aligned: query i sees keys [0, Skv - Sq + i]."""
    if return_lse:
        return flash_attention_lse(q, k, v, causal=causal, scale=scale)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s, _ = _scores(q, k, causal, scale)                   # (B,Hkv,G,Sq,Skv)
    vf = v.float().permute(0, 2, 1, 3).unsqueeze(2)
    return _heads_last(_softmax_pv(s, vf)).to(q.dtype)


def flash_attention_p_rounded(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              scale: Optional[float] = None) -> torch.Tensor:
    """:func:`flash_attention` with p rounded once to bf16 before PV (l
    sums the float32 p): what a tensor-core PV without the bf16 forward's
    hi/lo split of p would compute. No path of the port runs it; the card
    checks set the bf16 kernel's outputs against it and against
    :func:`flash_attention`, to show that p keeps float32 accuracy there."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s, _ = _scores(q, k, causal, scale)
    vf = v.float().permute(0, 2, 1, 3).unsqueeze(2)
    return _heads_last(_softmax_pv(s, vf, round_p=True)).to(q.dtype)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None):
    """The forward with its residual, as ``_flash_kernel_lse`` computes it:
    (o (B,Sq,Hq,D) in q's dtype, lse (B,Hq,Sq) float32), lse = m +
    log(max(l, 1e-30)) of the scaled, masked scores; -inf for a row that
    sees no key."""
    B, Sq, Hq, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    s, _ = _scores(q, k, causal, scale)
    vf = v.float().permute(0, 2, 1, 3).unsqueeze(2)
    o = _softmax_pv(s, vf)
    m = s.amax(dim=-1)
    m0 = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    l = torch.exp(s - m0[..., None]).sum(dim=-1)
    lse = m + torch.log(l.clamp_min(1e-30))               # (B,Hkv,G,Sq)
    return _heads_last(o).to(q.dtype), lse.reshape(B, Hq, Sq)


def _probs_ds(q, k, v, do, lse, delta, causal: bool, scale: float):
    """p and ds (B, Hkv, G, Sq, Skv) float32: p = exp(s - lse) on visible
    entries, 0 elsewhere (never exp of a masked entry: lse may be -inf);
    ds = p (do v^T - delta)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    s, vis = _scores(q, k, causal, scale)
    lse5 = lse.float().reshape(B, Hkv, G, Sq, 1)
    p = torch.where(vis, torch.exp(torch.where(vis, s, 0.0) - torch.where(
        vis, lse5, 0.0)), 0.0)
    dog = do.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)
    vf = v.float().permute(0, 2, 1, 3).unsqueeze(2)       # (B,Hkv,1,Skv,D)
    dp = dog @ vf.transpose(-1, -2)
    ds = p * (dp - delta.float().reshape(B, Hkv, G, Sq, 1))
    return p, ds, dog


def _dq(q, k, v, do, lse, delta, causal, scale, round_once):
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    _, ds, _ = _probs_ds(q, k, v, do, lse, delta, causal, scale)
    if round_once:
        ds = ds.bfloat16().float()
    kf = k.float().permute(0, 2, 1, 3).unsqueeze(2)
    return _heads_last((ds @ kf) * scale).to(q.dtype)


def _dkv(q, k, v, do, lse, delta, causal, scale, round_once):
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    p, ds, dog = _probs_ds(q, k, v, do, lse, delta, causal, scale)
    if round_once:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D).permute(0, 2, 3, 1, 4)
    dk = (ds.transpose(-1, -2) @ qg).sum(dim=2) * scale   # (B,Hkv,Skv,D)
    dv = (p.transpose(-1, -2) @ dog).sum(dim=2)
    return (dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def flash_dq(q, k, v, do, lse, delta, *, causal: bool = True,
             scale: Optional[float] = None) -> torch.Tensor:
    """dq = scale * ds k, (B,Sq,Hq,D) in q's dtype. do as q; lse and delta
    (B,Hq,Sq) float32 (delta = rowsum(do * o))."""
    return _dq(q, k, v, do, lse, delta, causal, scale, False)


def flash_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
              scale: Optional[float] = None):
    """(dk, dv), each (B,Skv,Hkv,D) in k's dtype: dk = scale * ds^T q and
    dv = p^T do, summed over the GQA group in float32 before the one
    rounding."""
    return _dkv(q, k, v, do, lse, delta, causal, scale, False)


def flash_dq_rounded(q, k, v, do, lse, delta, *, causal: bool = True,
                     scale: Optional[float] = None) -> torch.Tensor:
    """:func:`flash_dq` with ds rounded once to bf16 before ds k: what a
    tensor-core dq without the bf16 kernel's hi/lo split of ds would
    compute. No path of the port runs it; the checks set the bf16 kernel's
    outputs against it and against :func:`flash_dq`, to show that ds keeps
    float32 accuracy there (as :func:`flash_attention_p_rounded` does for
    the forward's p)."""
    return _dq(q, k, v, do, lse, delta, causal, scale, True)


def flash_dkv_rounded(q, k, v, do, lse, delta, *, causal: bool = True,
                      scale: Optional[float] = None):
    """:func:`flash_dkv` with p and ds rounded once to bf16 before p^T do
    and ds^T q; run by no path, a yardstick as :func:`flash_dq_rounded`."""
    return _dkv(q, k, v, do, lse, delta, causal, scale, True)


def local_valid(kv_valid_len, rows: int, base: int = 0,
                stride: Optional[int] = None) -> torch.Tensor:
    """How many of a row's local pool rows are valid under a row map:
    local row j of table entry i stands for position i * stride + base +
    j (rows a page, stride >= rows), and is valid below the row's valid
    length. Positions grow with (i, j), so the valid rows are a prefix of
    the local ones; this is its length. At base 0 and stride ``rows`` it
    is the valid length itself. A pool split over m ranks by page rows has
    rows = page_size / m, stride = page_size, base = rank * rows; the slot
    pool's page view, rows = stride = 16 and base = rank * its rows."""
    stride = rows if stride is None else stride
    q = torch.as_tensor(kv_valid_len).to(torch.int64) - base
    i = torch.div(q, stride, rounding_mode="floor")
    n = i * rows + torch.clamp(q - i * stride, max=rows)
    return torch.where(q > 0, n, torch.zeros_like(n)).to(torch.int32)


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 page_table: torch.Tensor, kv_valid_len, *,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None,
                 scale: Optional[float] = None, row_base: int = 0,
                 row_stride: Optional[int] = None, return_lse: bool = False):
    """Single-query decode attention through a page table. q (B,1,Hq,D);
    pools (num_pages, page_size, Hkv, D) of float32, bf16 or int8 (then
    ``k_scale``/``v_scale`` (num_pages, page_size, Hkv) float32, dequantized
    as code * scale); page_table (B, npages) int; kv_valid_len scalar or (B,)
    -> (B,1,Hq,D) in q's dtype, and with ``return_lse`` also the lse (B, Hq)
    float32 (-inf for a row with no valid position). Positions at or past a
    row's valid length (table entries 0, the scratch page, among them)
    weigh exactly 0. ``row_base``/``row_stride``: the row map of a pool of
    one rank's rows (:func:`local_valid`)."""
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
    valid = local_valid(kv_valid_len, P, row_base, row_stride).to(q.device)
    valid = valid.reshape(-1).expand(B).reshape(B, 1, 1, 1, 1)
    qg = q.float().reshape(B, Hkv, group, 1, D)
    kf = k.permute(0, 2, 1, 3).unsqueeze(2)               # (B,Hkv,1,T,D)
    vf = v.permute(0, 2, 1, 3).unsqueeze(2)
    s = (qg @ kf.transpose(-1, -2)) * scale               # (B,Hkv,G,1,T)
    pos = torch.arange(s.shape[-1], device=q.device)
    s = s.masked_fill(pos >= valid, float("-inf"))
    o = _softmax_pv(s, vf).reshape(B, 1, Hq, D).to(q.dtype)
    if not return_lse:
        return o
    m = s.amax(dim=-1)
    m0 = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    l = torch.exp(s - m0[..., None]).sum(dim=-1)
    return o, (m + torch.log(l.clamp_min(1e-30))).reshape(B, Hq)


def paged_decode_gathered(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, page_table: torch.Tensor,
                          kv_valid_len, *,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None, row_base: int = 0,
                          row_stride: Optional[int] = None,
                          return_lse: bool = False):
    """The same function as :func:`paged_decode` by the JAX package's XLA
    route (``repro.models.attention._paged_attention_xla``): the row's pages
    gathered in the pool's dtype (int8 dequantized to float32), then the
    slot decode's chunked attention (``models.attention.chunked_attention``:
    p rounded to v's dtype before p·v) with a per-row valid length (under a
    row map, the count of valid local rows, :func:`local_valid`) and, with
    ``return_lse``, its lse (B, Hq). It is the op's CPU path, so the paged
    engine's rows get the slot engine's bits, as JAX's XLA route gives
    them; :func:`paged_decode` (the Pallas kernel's arithmetic) stays the
    oracle the CUDA kernel is held to."""
    from repro_torch.models.attention import (KV_CHUNK_DEFAULT,
                                              chunked_attention)
    B = q.shape[0]
    P, Hkv, D = k_pool.shape[1], k_pool.shape[2], k_pool.shape[3]
    table = page_table.long()
    k = k_pool[table].reshape(B, -1, Hkv, D)
    v = v_pool[table].reshape(B, -1, Hkv, D)
    if k_scale is not None:
        k = k.float() * k_scale[table].reshape(B, -1, Hkv)[..., None]
        v = v.float() * v_scale[table].reshape(B, -1, Hkv)[..., None]
    if row_base or (row_stride is not None and row_stride != P):
        kv_valid_len = local_valid(kv_valid_len, P, row_base, row_stride)
    out = chunked_attention(q, k, v, causal=False, chunk=KV_CHUNK_DEFAULT,
                            scale=scale, kv_valid_len=kv_valid_len,
                            return_lse=return_lse)
    if not return_lse:
        return out
    return out[0], out[1][..., 0]


def merge_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """The attention over all of a model group's rows from each rank's
    partial: o (m, B, 1, Hq, D), each rank's attention over its own rows,
    and lse (m, B, Hq) float32, stacked in rank order -> (B, 1, Hq, D) in
    o's dtype: sum_r exp(lse_r - lse) o_r, lse = logsumexp_r lse_r, summed
    in float32 in rank order, so every rank that merges the same gathered
    partials gets the same bits. A rank with no valid row (lse -inf)
    weighs 0."""
    top = lse.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lse - top)                               # (m, B, Hq)
    total = torch.zeros_like(top)
    acc = torch.zeros(o.shape[1:], dtype=torch.float32, device=o.device)
    for r in range(o.shape[0]):
        total = total + w[r]
        acc = acc + w[r][:, None, :, None] * o[r].float()
    return (acc / total.clamp_min(1e-30)[:, None, :, None]).to(o.dtype)

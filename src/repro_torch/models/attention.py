"""GQA attention (the counterpart of ``repro.models.attention``).

Three paths, chosen explicitly by the caller's arguments:

* :func:`attention` without ``kv_valid_len`` — the teacher-forced forward —
  runs ``kernels.flash_attention.ops.flash_attention``: the registry op
  ``flash_attention`` (backend ``cuda``: the Hopper kernel; ``torch``: its
  plain version), and under autograd the Function whose backward runs the
  ops ``flash_dq`` and ``flash_dkv``.
* :func:`attention` with ``kv_valid_len`` — the slot-cache decode — runs
  :func:`chunked_attention`, plain PyTorch, as the JAX package runs its XLA
  path there. JAX reaches the same split through the Pallas impl's
  ``supports`` predicate and a silent fallback inside its registry; the
  port makes the routing explicit here and its registry has no fallback.
* :func:`paged_attention` — decode through a page table — dispatches the
  registry op ``paged_attention`` (kernel ``paged_decode``).

Layouts are the model's: (B, S, H, D).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import registry
from repro_torch.kernels.flash_attention import ops as fa_ops

NEG_INF = -1e30

#: q blocks engage above this length (keeps small/smoke cases single-block)
Q_CHUNK_DEFAULT = 2048
KV_CHUNK_DEFAULT = 1024


def _attn_inner(q, k, v, *, causal: bool, chunk: int, scale: float,
                kv_valid_len, qpos_offset: int):
    """Online softmax over kv chunks. q (B,Sq,Hq,D); k,v (B,Skv,Hkv,D).
    Global query position of row i is qpos_offset + i (for causal masking).
    The arithmetic of the JAX XLA path: scores of the stream-dtype operands
    summed in float32, p rounded to v's dtype for p·v, float32 sums."""
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    chunk = min(chunk, Skv)
    nkc = -(-Skv // chunk)
    pad = nkc * chunk - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    # kv_valid_len may be scalar (shared cache fill) or (B,) (per-slot fill)
    valid = torch.as_tensor(Skv if kv_valid_len is None else kv_valid_len,
                            device=q.device).to(torch.int32).reshape(-1, 1, 1)
    qg = q.reshape(B, S, Hkv, group, D).float()
    qpos = torch.arange(S, dtype=torch.int32, device=q.device) + qpos_offset

    m = torch.full((B, Hkv, group, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, group, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, group, S, D), dtype=torch.float32,
                      device=q.device)
    for ic in range(nkc):
        kb = k[:, ic * chunk:(ic + 1) * chunk]
        vb = v[:, ic * chunk:(ic + 1) * chunk]
        s = torch.einsum("bskgd,btkd->bkgst", qg, kb.float()) * scale
        kpos = ic * chunk + torch.arange(chunk, dtype=torch.int32,
                                         device=q.device)
        mask = kpos[None, None, :] < valid                 # (1|B, 1, chunk)
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])[None]
        s = torch.where(mask[:, None, None], s,
                        torch.full((), NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype).float(),
                          vb.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    out = out.reshape(B, Hkv * group, S, D).transpose(1, 2)
    return out.to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool = True,
                      chunk: int = KV_CHUNK_DEFAULT,
                      q_chunk: Optional[int] = Q_CHUNK_DEFAULT,
                      scale: Optional[float] = None, kv_valid_len=None):
    """Flash-style attention in plain PyTorch, (B,S,H,D) layout; see
    :func:`_attn_inner`. Long query axes are blocked by ``q_chunk``, and a
    causal q block with a static mask scans only the kv prefix it sees."""
    B, S, Hq, D = q.shape
    Skv = k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    off = Skv - S                                     # right-aligned queries

    if q_chunk is None or S <= q_chunk:
        return _attn_inner(q, k, v, causal=causal, chunk=chunk, scale=scale,
                           kv_valid_len=kv_valid_len, qpos_offset=off)

    if S % q_chunk:
        raise ValueError(f"callers pad seq to the q-chunk multiple: S={S}, "
                         f"q_chunk={q_chunk}")
    outs = []
    for i in range(0, S, q_chunk):
        qb = q[:, i:i + q_chunk]
        if causal and kv_valid_len is None:
            kv_end = min(-(-(off + i + q_chunk) // chunk) * chunk, Skv)
        else:
            kv_end = Skv
        outs.append(_attn_inner(
            qb, k[:, :kv_end], v[:, :kv_end], causal=causal, chunk=chunk,
            scale=scale, kv_valid_len=kv_valid_len, qpos_offset=off + i))
    return torch.cat(outs, dim=1)


def attention(q, k, v, *, causal: bool = True, scale=None, kv_valid_len=None,
              chunk: Optional[int] = None,
              q_chunk: Optional[int] = Q_CHUNK_DEFAULT):
    """GQA attention, (B,S,H,D) layout. With ``kv_valid_len`` (a cache read
    masked per row) it runs :func:`chunked_attention`; without, the
    differentiable ``flash_attention`` under the active backend policy."""
    if kv_valid_len is not None:
        return chunked_attention(q, k, v, causal=causal,
                                 chunk=chunk or KV_CHUNK_DEFAULT,
                                 q_chunk=q_chunk, scale=scale,
                                 kv_valid_len=kv_valid_len)
    return fa_ops.flash_attention(q, k, v, causal=causal, scale=scale)


def quantize_kv(x: torch.Tensor):
    """Symmetric per-(row, head) int8 quantization over head_dim.

    x (..., D) -> ``(q, scale)``: int8 codes plus the float32 absmax/127
    scale with the trailing axis reduced — the layout of the paged pool's
    ``k_scale``/``v_scale`` leaves. All-zero rows get scale 1.0 so
    dequantization of never-written pool rows stays exactly 0.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0.0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def paged_attention(q, k_pool, v_pool, page_table, kv_valid_len, *,
                    k_scale=None, v_scale=None, scale=None):
    """Decode attention over a paged KV pool, dispatched to the registry op
    ``paged_attention``.

    q (B,1,Hq,D); pools (num_pages, page_size, Hkv, D); page_table
    (B, pages_per_slot) int32 mapping each batch row's logical pages to pool
    pages; kv_valid_len (B,) int32 valid KV length per row. Rows past
    ``kv_valid_len`` — everything reached through table entry 0, the serve
    layer's scratch page, among them — weigh exactly 0. Quantized pools
    pass int8 K/V plus ``k_scale``/``v_scale`` (num_pages, page_size, Hkv)
    float32, dequantized on read (``x = int8 * scale``).
    """
    return registry.dispatch("paged_attention", q, k_pool, v_pool,
                             page_table, kv_valid_len, k_scale=k_scale,
                             v_scale=v_scale, scale=scale)

"""Transformer blocks: the GQA attention block with its KV cache, and the
dense and MoE pre-norm decoder blocks (the counterpart of
``repro.models.blocks``; zamba2's superblock is a loop in
``models.transformer``).

The KV cache is written in place. JAX's block is functional
(``cache["k"].at[pidx, off].set(...)``); here the new row lands straight in
the cache tensor the caller passed, which the serving engine owns for the
engine's life. That is safe for the same reason the JAX k-step block's
writes are (``repro_torch.serve.decode``): a frozen or finished slot keeps
writing at a position at or past its own ``kv_valid`` horizon, which no
read unmasks, and a freed slot's page-table row is all 0, so its writes
land in page 0, the pool's scratch page, which no read unmasks either.

On a model axis (``models.tp``) a pool holds one rank's slice of each
page's rows (:class:`PagedRows`' row map): the rank that owns the new
position's row writes it, and the others write back what their clamped
row already holds, so no rank's rows change but the owner's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import tp
from repro_torch.models.attention import attention, paged_attention, quantize_kv
from repro_torch.models.layers import apply_rope, dense_init, rms_norm
from repro_torch.models.mlp import init_swiglu, swiglu
from repro_torch.models.moe import init_moe, moe_ffn


def init_attn(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
              head_dim: int, dtype=torch.float32, device=None) -> dict:
    return dict(
        wq=dense_init(gen, (d, n_heads * head_dim), dtype=dtype, device=device),
        wk=dense_init(gen, (d, n_kv * head_dim), dtype=dtype, device=device),
        wv=dense_init(gen, (d, n_kv * head_dim), dtype=dtype, device=device),
        wo=dense_init(gen, (n_heads * head_dim, d), dtype=dtype, device=device),
    )


def _write_rows(leaf: torch.Tensor, cache_pos, new: torch.Tensor) -> None:
    """leaf[b, cache_pos(+s)] = new[b, s] in place, leaf (B, Smax, ...),
    new (B, S, ...). cache_pos is a scalar (the whole batch at one depth)
    or (B,) (one depth per row); the start is clamped so the S rows fit, as
    ``lax.dynamic_update_slice`` clamps it."""
    B, S = new.shape[:2]
    Smax = leaf.shape[1]
    start = torch.as_tensor(cache_pos, device=leaf.device).long()
    start = start.clamp(0, Smax - S)
    cols = start.reshape(-1, 1) + torch.arange(S, device=leaf.device)
    rows = torch.arange(B, device=leaf.device)[:, None]
    leaf[rows, cols.expand(B, S)] = new.to(leaf.dtype)


class PagedRows(NamedTuple):
    """Where a decode step writes in a paged pool, and what it then reads:
    pool page (B,), row in the page (B,) and valid length (B,) for per-row
    positions. Under a row map (a pool of one rank's rows of every page:
    local row j of table entry i is position ``i * stride + base + j``)
    also ``own`` (B,) bool, whether this rank holds the written row (else
    page and row are clamped into the row's own entries), the map, and the
    model group's :class:`models.tp.RowShard` when the rows are split
    across it (the attention then merges over the group)."""
    pidx: torch.Tensor
    off: torch.Tensor
    valid: torch.Tensor
    own: Optional[torch.Tensor] = None
    base: int = 0
    stride: Optional[int] = None
    shard: Optional[tp.RowShard] = None


def paged_rows(page_table: torch.Tensor, cache_pos: torch.Tensor,
               page_size: int, *, stride: Optional[int] = None,
               base: int = 0, shard=None) -> PagedRows:
    """The :class:`PagedRows` of per-row positions ``cache_pos`` in pages
    of ``page_size`` (local) rows, under the row map ``stride``/``base``
    when given. The same for every layer of a step."""
    if stride is None:
        pidx = page_table.gather(1, (cache_pos // page_size)[:, None].long())
        return PagedRows(pidx[:, 0].long(), (cache_pos % page_size).long(),
                         cache_pos + 1)
    q = cache_pos.long() - base
    i = torch.div(q, stride, rounding_mode="floor")
    j = q - i * stride
    npages = page_table.shape[1]
    own = (q >= 0) & (j < page_size) & (i < npages)
    i, j = i.clamp(0, npages - 1), j.clamp(0, page_size - 1)
    pidx = page_table.gather(1, i[:, None])[:, 0].long()
    return PagedRows(pidx, j, cache_pos + 1, own, base, stride, shard)


def _put(leaf: torch.Tensor, rows: PagedRows, new: torch.Tensor) -> None:
    """leaf[page, row] = new (B, ...) in place, where this rank owns the
    row; elsewhere the row keeps what it holds."""
    new = new.to(leaf.dtype)
    if rows.own is not None:
        own = rows.own.view(-1, *([1] * (new.dim() - 1)))
        new = torch.where(own, new, leaf[rows.pidx, rows.off])
    leaf[rows.pidx, rows.off] = new


def attn_forward(params: dict, x: torch.Tensor, *, n_heads: int, n_kv: int,
                 head_dim: int, rope, causal: bool = True,
                 cache: Optional[dict] = None, cache_pos=None,
                 kv_override=None, attn_chunk: Optional[int] = None,
                 page_table: Optional[torch.Tensor] = None, rows=None):
    """GQA attention. x (B,S,d) -> (out (B,S,d), cache).

    cache: dict(k=(B,Smax,Hkv,Dh), v=...) written in place at cache_pos
    (decode). cache_pos: scalar (whole batch at one depth, the classic
    decode) or (B,) int32 (a depth per row, the continuous-batching engine).
    page_table: (B, pages_per_slot) int32 — the cache leaves are then a
    paged pool (num_pages, page_size, Hkv, Dh), position p of row b lives
    at page ``page_table[b, p // page_size]``, row ``p % page_size``, and an
    int8 pool carries ``k_scale``/``v_scale`` (num_pages, page_size, Hkv)
    beside its codes (decode only: S == 1 with per-row cache_pos).
    rope: this step's ``repro_torch.models.layers.rope_tables`` (or
    ``mrope_tables``), or None: q and k are not rotated (cross-attention,
    as JAX with no positions); rows: its :func:`paged_rows` (required with
    ``page_table``). The caller computes both once for every layer of the
    step.
    Weights split over the model axis (DTensors, ``models.tp``): a decode
    step, and a forward whose heads do not divide the axis, take q, k and
    v whole on every rank (replicated), read the rank's rows of the pool
    through ``rows``' map and merge the ranks' partials
    (``tp.merge_ranks``); a forward whose heads divide the axis runs on
    the rank's own heads.
    kv_override: (k, v) (B, Skv, Hkv, Dh) for cross-attention (whisper's
    decoder): K/V are not projected nor rotated, and with no cache the
    attention is ``flash_attention`` (the kernel on the card) at any Sq,
    decode's single query too, as JAX runs its Pallas kernel there.
    """
    B, S, d = x.shape
    q = tp.matmul(x, params["wq"].to(x.dtype))
    split = tp.is_tp(q)
    # serving on the model axis: every rank all heads of its own rows
    whole = split and (cache is not None
                       or not tp.divides(n_heads, n_kv, q))
    like = q
    if whole:
        q = tp.local(q)
    q = q.reshape(B, S, n_heads, head_dim)
    if kv_override is None:
        k = tp.matmul(x, params["wk"].to(x.dtype))
        v = tp.matmul(x, params["wv"].to(x.dtype))
        if whole:
            k, v = tp.local(k), tp.local(v)
        k = k.reshape(B, S, n_kv, head_dim)
        v = v.reshape(B, S, n_kv, head_dim)
        if split and not whole:
            # the kernels run on this rank's heads (models.tp)
            q, k, v = tp.heads(q), tp.heads(k), tp.heads(v)
        if rope is not None:
            q = apply_rope(q, None, tables=rope)
            k = apply_rope(k, None, tables=rope)
    else:
        k, v = kv_override

    kv_valid = None
    if cache is not None and page_table is not None:
        if S != 1 or rows is None:
            raise ValueError("paged KV cache is decode-only: S == 1 with "
                             "the step's paged_rows")
        mapped = {} if rows.stride is None else dict(
            row_base=rows.base, row_stride=rows.stride,
            return_lse=rows.shard is not None)
        if "k_scale" in cache:
            # int8 pool: quantize on scatter — codes and their per-(row,
            # head) scales land in the same page row, so a page is
            # self-describing and defrag moves both together
            kq, ks = quantize_kv(k[:, 0])
            vq, vs = quantize_kv(v[:, 0])
            for name, new in (("k", kq), ("v", vq), ("k_scale", ks),
                              ("v_scale", vs)):
                _put(cache[name], rows, new)
            o = paged_attention(q, cache["k"], cache["v"], page_table,
                                rows.valid, k_scale=cache["k_scale"],
                                v_scale=cache["v_scale"], **mapped)
        else:
            _put(cache["k"], rows, k[:, 0])
            _put(cache["v"], rows, v[:, 0])
            o = paged_attention(q, cache["k"], cache["v"], page_table,
                                rows.valid, **mapped)
        if rows.shard is not None:
            o = tp.merge_ranks(*o, rows.shard)
        o = o.reshape(B, S, n_heads * head_dim)
        if whole:
            return tp.replicate(tp.matmul(tp.replicated(o, like),
                                          params["wo"].to(x.dtype))), cache
        return o @ params["wo"].to(x.dtype), cache
    if whole and cache is not None:
        raise ValueError("a decode step on the model axis reads its cache "
                         "through a page table (decode_step's slot view)")
    if cache is not None:
        _write_rows(cache["k"], cache_pos, k)
        _write_rows(cache["v"], cache_pos, v)
        k, v = cache["k"], cache["v"]
        kv_valid = cache_pos + S
        causal = False if S == 1 else causal   # single query: mask via kv_valid

    o = attention(q, k, v, causal=causal, chunk=attn_chunk,
                  kv_valid_len=kv_valid)
    if whole:
        o = tp.replicated(o, like)
    elif split:
        o = tp.from_heads(o, like)
    o = o.reshape(B, S, n_heads * head_dim)
    return tp.replicate(tp.matmul(o, params["wo"].to(x.dtype))), cache


def init_attn_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                    dtype=torch.bfloat16, device=None) -> dict:
    shape = (batch, max_len, n_kv, head_dim)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device))


def init_dense_block(gen: torch.Generator, cfg, dtype=torch.float32,
                     device=None) -> dict:
    return dict(
        ln1=torch.ones(cfg.d_model, dtype=dtype, device=device),
        attn=init_attn(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, dtype, device),
        ln2=torch.ones(cfg.d_model, dtype=dtype, device=device),
        mlp=init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype, device),
    )


def dense_block(params: dict, x: torch.Tensor, cfg, *, pos_info: dict,
                cache: Optional[dict] = None, cache_pos=None,
                page_table: Optional[torch.Tensor] = None):
    h, new_cache = attn_forward(
        params["attn"], rms_norm(x, params["ln1"], cfg.norm_eps),
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope=pos_info["rope"], cache=cache, cache_pos=cache_pos,
        page_table=page_table, rows=pos_info.get("rows"))
    x = x + h
    x = x + swiglu(params["mlp"], rms_norm(x, params["ln2"], cfg.norm_eps))
    return x, new_cache


def init_moe_block(gen: torch.Generator, cfg, dtype=torch.float32,
                   device=None) -> dict:
    return dict(
        ln1=torch.ones(cfg.d_model, dtype=dtype, device=device),
        attn=init_attn(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, dtype, device),
        ln2=torch.ones(cfg.d_model, dtype=dtype, device=device),
        moe=init_moe(gen, cfg.d_model, cfg.moe_d_ff, cfg.n_experts,
                     cfg.n_shared_experts,
                     cfg.moe_d_ff * cfg.n_shared_experts, dtype, device),
    )


def moe_block(params: dict, x: torch.Tensor, cfg, *, pos_info: dict,
              cache: Optional[dict] = None, cache_pos=None,
              page_table: Optional[torch.Tensor] = None):
    """The dense block with the MoE FFN: (x, cache, aux)."""
    h, new_cache = attn_forward(
        params["attn"], rms_norm(x, params["ln1"], cfg.norm_eps),
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope=pos_info["rope"], cache=cache, cache_pos=cache_pos,
        page_table=page_table, rows=pos_info.get("rows"))
    x = x + h
    m, aux = moe_ffn(params["moe"], rms_norm(x, params["ln2"], cfg.norm_eps),
                     top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    return x + m, new_cache, aux

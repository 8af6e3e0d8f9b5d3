"""Whisper-style encoder-decoder blocks (the counterpart of
``repro.models.encdec``). The audio conv front end is a stub, as in the
JAX package: callers provide frame embeddings (B, S, d).

The encoder's self-attention is not causal and rotates q and k by the frame
positions; the decoder's self-attention is causal with a cache, its
cross-attention reads the encoder's K/V (``kv_override``) unrotated and
runs ``flash_attention``, at decode's single query too.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.blocks import attn_forward, init_attn
from repro_torch.models.layers import rms_norm, rope_tables
from repro_torch.models.mlp import gelu_mlp, init_gelu_mlp


def init_enc_block(gen: torch.Generator, cfg, dtype=torch.float32,
                   device=None) -> dict:
    return dict(
        ln1=torch.ones(cfg.d_model, dtype=dtype, device=device),
        attn=init_attn(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, dtype, device),
        ln2=torch.ones(cfg.d_model, dtype=dtype, device=device),
        mlp=init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
    )


def enc_tables(x: torch.Tensor, cfg):
    """The encoder's rotary tables: positions arange(S) in every row (the
    same for every layer; JAX recomputes them in each)."""
    B, S, _ = x.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return rope_tables(pos, cfg.head_dim, cfg.rope_theta)


def enc_block(params: dict, x: torch.Tensor, cfg, rope) -> torch.Tensor:
    """One encoder layer: non-causal self-attention, then the GeLU MLP.
    ``rope``: :func:`enc_tables` of x."""
    h, _ = attn_forward(params["attn"],
                        rms_norm(x, params["ln1"], cfg.norm_eps),
                        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                        head_dim=cfg.head_dim, rope=rope, causal=False)
    x = x + h
    return x + gelu_mlp(params["mlp"],
                        rms_norm(x, params["ln2"], cfg.norm_eps))


def init_dec_block(gen: torch.Generator, cfg, dtype=torch.float32,
                   device=None) -> dict:
    return dict(
        ln1=torch.ones(cfg.d_model, dtype=dtype, device=device),
        self_attn=init_attn(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, dtype, device),
        ln2=torch.ones(cfg.d_model, dtype=dtype, device=device),
        cross_attn=init_attn(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim, dtype, device),
        ln3=torch.ones(cfg.d_model, dtype=dtype, device=device),
        mlp=init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device),
    )


def cross_kv(params: dict, enc_out: torch.Tensor, cfg):
    """The cross-attention K/V of one decoder layer from the encoder's
    output (cached at decode): (k, v) (B, S_enc, Hkv, Dh)."""
    B, S, _ = enc_out.shape
    w = params["cross_attn"]
    k = enc_out @ w["wk"].to(enc_out.dtype)
    v = enc_out @ w["wv"].to(enc_out.dtype)
    return (k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim))


def dec_block(params: dict, x: torch.Tensor, cfg, *, kv_cross, pos_info,
              cache: Optional[dict] = None, cache_pos=None,
              page_table: Optional[torch.Tensor] = None):
    """One decoder layer: causal self-attention (with ``cache``, written in
    place at ``cache_pos``; a paged pool with ``page_table``, the cross K/V
    staying in the slot layout), cross-attention on ``kv_cross``, the GeLU
    MLP. Returns (x, cache)."""
    h, new_cache = attn_forward(
        params["self_attn"], rms_norm(x, params["ln1"], cfg.norm_eps),
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope=pos_info["rope"], cache=cache, cache_pos=cache_pos,
        page_table=page_table, rows=pos_info.get("rows"))
    x = x + h
    h, _ = attn_forward(
        params["cross_attn"], rms_norm(x, params["ln2"], cfg.norm_eps),
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope=None, causal=False, kv_override=kv_cross)
    x = x + h
    return x + gelu_mlp(params["mlp"],
                        rms_norm(x, params["ln3"], cfg.norm_eps)), new_cache

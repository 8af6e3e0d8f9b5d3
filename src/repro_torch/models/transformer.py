"""Model orchestration for the dense and ssm families: init, forward,
loss, cache, decode (the counterpart of ``repro.models.transformer``).

Parameters are a plain dict of tensors: ``embed`` (V, d), ``ln_f`` (d,),
``lm_head`` (d, V) and ``layers``, a list of one dict per layer (JAX
stacks the layers along a leading axis for ``lax.scan``; the port loops):
a dense layer holds ``ln1``, ``attn``, ``ln2`` and ``mlp``, an ssm layer
(mamba2) ``ln`` and ``mamba``. The other families raise until their
ROADMAP item brings them.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import registry
from repro_torch.models.blocks import dense_block, init_dense_block, paged_rows
from repro_torch.models.layers import (dense_init, embed_init, rms_norm,
                                      rope_tables)
from repro_torch.models.ssm import (init_mamba2, init_mamba2_state,
                                    mamba2_decode_step, mamba2_forward)
from repro_torch.tree import leaves

#: the families the port's model runs
FAMILIES = ("dense", "ssm")
#: where each unported family comes from (ROADMAP, queue 1)
_LATER = {
    "moe": "ROADMAP queue 1 item 6 (models: moe.py)",
    "hybrid": "ROADMAP queue 1 item 6 (models: hybrid zamba2)",
    "audio": "ROADMAP queue 1 item 6 (models: encdec.py)",
    "vlm": "ROADMAP queue 1 item 6 (models: frontend.py, M-RoPE)",
}


def require_supported(cfg) -> None:
    """Raise for a family the port's model does not run yet, naming its
    item."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; it comes "
            f"with {_LATER.get(cfg.family, 'a later ROADMAP item')}")


def init_params(cfg, gen: torch.Generator, dtype=torch.float32,
                device=None) -> dict:
    """Random weights from ``gen``: embeddings N(0, 1/d), projections
    N(0, 1/fan_in), norms 1, as ``repro.models.init_params`` draws them
    (``torch.Generator`` gives other numbers than ``jax.random``). An ssm
    layer keeps ``A_log`` and ``dt_bias`` in float32 whatever ``dtype``
    (``models.ssm``)."""
    require_supported(cfg)
    device = gen.device if device is None else device
    params = dict(embed=embed_init(gen, cfg.vocab, cfg.d_model, dtype,
                                   device),
                  ln_f=torch.ones(cfg.d_model, dtype=dtype, device=device))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab),
                                       dtype=dtype, device=device)
    if cfg.family == "ssm":
        params["layers"] = [
            dict(ln=torch.ones(cfg.d_model, dtype=dtype, device=device),
                 mamba=init_mamba2(gen, cfg.d_model, cfg, dtype, device))
            for _ in range(cfg.n_layers)]
    else:
        params["layers"] = [init_dense_block(gen, cfg, dtype, device)
                            for _ in range(cfg.n_layers)]
    return params


def param_count(params) -> int:
    return sum(t.numel() for t in leaves(params))


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings in the bf16 stream (JAX: take, then astype)."""
    return F.embedding(tokens.long(), params["embed"]).to(torch.bfloat16)


def _logits(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the vocabulary projection, a bf16 product as in
    JAX."""
    x = rms_norm(x, params["ln_f"].float(), cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(x.dtype)
    return x @ head


def _block(lp, x, cfg, pos_info):
    if cfg.family == "ssm":
        return x + mamba2_forward(lp["mamba"],
                                  rms_norm(x, lp["ln"], cfg.norm_eps), cfg)
    return dense_block(lp, x, cfg, pos_info=pos_info)[0]


def forward(params, cfg, batch: dict, *, last_only: bool = False,
            remat: bool = False):
    """Teacher-forced forward: batch["tokens"] (B, S) -> (logits (B,S,V)
    bf16, aux 0). ``last_only`` projects the final position only (the
    prefill path). Attention runs ``flash_attention`` and a mamba2 layer's
    scan ``ssd`` (each its autograd Function when grad is on). ``remat``
    checkpoints each layer (``torch.utils.checkpoint``, non-reentrant): its
    activations are recomputed in the backward, the counterpart of JAX's
    ``jax.checkpoint(nothing_saveable)`` around each scanned layer. The
    recompute runs under the registry policy of the forward."""
    require_supported(cfg)
    tokens = batch["tokens"]
    x = _embed(params, tokens)
    B, S = tokens.shape
    pos_info = {}
    if cfg.family == "dense":
        pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        pos_info["rope"] = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    policy = registry.policy()

    def contexts():
        return contextlib.nullcontext(), registry.use(policy)

    for lp in params["layers"]:
        if remat and torch.is_grad_enabled():
            x = checkpoint(_block, lp, x, cfg, pos_info, use_reentrant=False,
                           context_fn=contexts)
        else:
            x = _block(lp, x, cfg, pos_info)
    if last_only:
        x = x[:, -1:]
    return _logits(params, cfg, x), torch.zeros((), device=x.device)


def loss_fn(params, cfg, batch: dict, *, remat: bool = False,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token cross entropy of batch["tokens"] against batch["labels"]
    (B, S), the counterpart of ``repro.models.transformer.loss_fn``: the
    bf16 logits upcast to float32, logsumexp minus the gold logit, the mean
    over tokens, plus ``aux_weight`` times the aux loss (0 for dense)."""
    logits, aux = forward(params, cfg, batch, remat=remat)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return (logz - gold).mean() + aux_weight * aux


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Decode cache: ``pos`` (scalar int32) and ``layers``: k/v
    (n_layers, batch, max_len, Hkv, Dh) for dense; for ssm the recurrent
    ``conv`` (n_layers, batch, K-1, conv channels) and ``ssm`` (n_layers,
    batch, H, P, N), float32 zeros whatever ``dtype``, as in JAX."""
    require_supported(cfg)
    if cfg.family == "ssm":
        st = init_mamba2_state(batch, cfg.d_model, cfg, device=device)
        return dict(pos=torch.zeros((), dtype=torch.int32, device=device),
                    layers={k: v.expand(cfg.n_layers, *v.shape).clone()
                            for k, v in st.items()})
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return dict(pos=torch.zeros((), dtype=torch.int32, device=device),
                layers=dict(k=torch.zeros(shape, dtype=dtype, device=device),
                            v=torch.zeros(shape, dtype=dtype, device=device)))


def decode_step(params, cfg, cache: dict, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache).

    positions: optional (B,) int32 per-slot decode depths (the
    continuous-batching engine): each row RoPEs at its own position and
    writes its K/V at its own index; ``cache["pos"]`` is then only
    advanced. Default: the scalar ``cache["pos"]`` shared by the batch.
    page_table: optional (B, pages_per_slot) int32 — the K/V leaves are a
    paged pool (``repro_torch.serve.paging``); requires ``positions``.

    The cache's K/V tensors are written in place (see
    ``repro_torch.models.blocks``); ``cache["pos"]`` is replaced. Attention
    dispatches ``paged_attention`` (paged) or runs ``chunked_attention``
    (slot cache). An ssm layer runs ``mamba2_decode_step`` and writes its
    conv window and state into the cache in place; it has no positions, so
    ``positions`` is not read, and no pages.
    """
    require_supported(cfg)
    if cfg.family == "ssm":
        return _ssm_decode_step(params, cfg, cache, tokens, page_table)
    B = tokens.shape[0]
    if page_table is not None and positions is None:
        raise ValueError("a paged cache needs per-row positions")
    if positions is None:
        pos = cache["pos"]
        rope_pos = pos.expand(B).reshape(B, 1)
    else:
        pos = positions
        rope_pos = positions[:, None]
    x = _embed(params, tokens)
    # what every layer of the step shares, computed once: the rotary
    # tables and, paged, the pool rows written and the valid lengths
    pos_info = dict(rope=rope_tables(rope_pos, cfg.head_dim, cfg.rope_theta))
    layers = cache["layers"]
    if page_table is not None:
        pos_info["rows"] = paged_rows(page_table, pos, layers["k"].shape[2])
    for i, lp in enumerate(params["layers"]):
        cl = {name: leaf[i] for name, leaf in layers.items()}
        x, _ = dense_block(lp, x, cfg, pos_info=pos_info, cache=cl,
                           cache_pos=pos, page_table=page_table)
    logits = _logits(params, cfg, x)
    cache = dict(cache, pos=cache["pos"] + 1)
    return logits, cache


def _ssm_decode_step(params, cfg, cache, tokens, page_table):
    if page_table is not None:
        raise NotImplementedError(
            f"{cfg.name}: a paged cache holds attention K/V; the ssm "
            f"family's recurrent leaves are pageless")
    x = _embed(params, tokens)
    layers = cache["layers"]
    for i, lp in enumerate(params["layers"]):
        st = {name: leaf[i] for name, leaf in layers.items()}
        h, new = mamba2_decode_step(lp["mamba"],
                                    rms_norm(x, lp["ln"], cfg.norm_eps), st,
                                    cfg)
        for name, leaf in st.items():
            leaf.copy_(new[name])
        x = x + h
    logits = _logits(params, cfg, x)
    return logits, dict(cache, pos=cache["pos"] + 1)


__all__ = ["init_params", "param_count", "forward", "loss_fn", "init_cache",
           "decode_step", "require_supported"]

"""Model orchestration for all six families: init, forward, loss, cache,
decode (the counterpart of ``repro.models.transformer``).

Parameters are a plain dict of tensors: ``embed`` (V, d), ``ln_f`` (d,),
``lm_head`` (d, V) and ``layers``, a list of one dict per layer (JAX
stacks the layers along a leading axis for ``lax.scan``; the port loops):

* dense, vlm: ``ln1``, ``attn``, ``ln2``, ``mlp`` a layer;
* moe: ``ln1``, ``attn``, ``ln2``, ``moe`` a layer, and deepseek's
  first layer, dense at ``d_ff = dense_d_ff``, as ``dense0`` beside them;
* ssm (mamba2): ``ln`` and ``mamba`` a layer;
* hybrid (zamba2): ``layers`` a list of ``n_layers / shared_attn_period``
  superblocks, each a list of ``shared_attn_period`` mamba2 layers, and
  ``shared`` (``ln``, ``attn``), one attention block after every
  superblock, its weights shared by all of them;
* audio (whisper): ``encoder`` (a list of ``n_enc_layers`` layers:
  ``ln1``, ``attn``, ``ln2``, ``mlp``), ``enc_ln``, and decoder
  ``layers`` (``ln1``, ``self_attn``, ``ln2``, ``cross_attn``, ``ln3``,
  ``mlp``).

whisper's frame embeddings (``batch["enc_embeds"]``) and qwen2-vl's patch
embeddings (``batch["vision_embeds"]``) are inputs, as in JAX, whose front
ends are stubs too.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import registry
from repro_torch.models import encdec, tp
from repro_torch.models.blocks import (attn_forward, dense_block, init_attn,
                                       init_dense_block, init_moe_block,
                                       moe_block, paged_rows)
from repro_torch.models.frontend import mrope_positions
from repro_torch.models.layers import (dense_init, embed_init, mrope_tables,
                                      rms_norm, rope_tables)
from repro_torch.models.ssm import (init_mamba2, init_mamba2_state,
                                    mamba2_decode_step, mamba2_forward)
from repro_torch.tree import leaves

#: the families the port's model runs: all of the JAX package's
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def require_supported(cfg) -> None:
    """Raise for a family neither the JAX package nor the port knows."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; "
                         f"known: {FAMILIES}")


def _dense0_cfg(cfg):
    """deepseek's first layer: a dense block at ``d_ff = dense_d_ff``."""
    return cfg.scaled(d_ff=cfg.dense_d_ff)


def _n_super(cfg) -> int:
    return cfg.n_layers // cfg.shared_attn_period


def _ssm_layer(gen, cfg, dtype, device) -> dict:
    return dict(ln=torch.ones(cfg.d_model, dtype=dtype, device=device),
                mamba=init_mamba2(gen, cfg.d_model, cfg, dtype, device))


def init_params(cfg, gen: Optional[torch.Generator], dtype=torch.float32,
                device=None) -> dict:
    """Random weights from ``gen``: embeddings N(0, 1/d), projections
    N(0, 1/fan_in), norms 1, biases 0, as ``repro.models.init_params``
    draws them (``torch.Generator`` gives other numbers than
    ``jax.random``). An ssm layer keeps ``A_log`` and ``dt_bias``, an MoE
    layer its ``router``, in float32 whatever ``dtype`` (the model reads
    them in float32). On the ``meta`` device ``gen`` may be None: the
    tree's shapes without a number drawn."""
    require_supported(cfg)
    device = gen.device if device is None else device
    ones = dict(dtype=dtype, device=device)
    params = dict(embed=embed_init(gen, cfg.vocab, cfg.d_model, dtype,
                                   device),
                  ln_f=torch.ones(cfg.d_model, **ones))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab),
                                       dtype=dtype, device=device)
    fam = cfg.family
    if fam in ("dense", "vlm"):
        params["layers"] = [init_dense_block(gen, cfg, dtype, device)
                            for _ in range(cfg.n_layers)]
    elif fam == "moe":
        if cfg.first_layer_dense:
            params["dense0"] = init_dense_block(gen, _dense0_cfg(cfg), dtype,
                                                device)
        params["layers"] = [
            init_moe_block(gen, cfg, dtype, device)
            for _ in range(cfg.n_layers - int(cfg.first_layer_dense))]
    elif fam == "ssm":
        params["layers"] = [_ssm_layer(gen, cfg, dtype, device)
                            for _ in range(cfg.n_layers)]
    elif fam == "hybrid":
        params["layers"] = [[_ssm_layer(gen, cfg, dtype, device)
                             for _ in range(cfg.shared_attn_period)]
                            for _ in range(_n_super(cfg))]
        params["shared"] = dict(
            ln=torch.ones(cfg.d_model, **ones),
            attn=init_attn(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, dtype, device))
    else:                                                   # audio
        params["encoder"] = [encdec.init_enc_block(gen, cfg, dtype, device)
                             for _ in range(cfg.n_enc_layers)]
        params["enc_ln"] = torch.ones(cfg.d_model, **ones)
        params["layers"] = [encdec.init_dec_block(gen, cfg, dtype, device)
                            for _ in range(cfg.n_layers)]
    return params


def param_count(params) -> int:
    return sum(t.numel() for t in leaves(params))


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings in the bf16 stream (JAX: take, then astype); a
    table split over the model axis read through ``tp.embedding``."""
    if tp.is_tp(params["embed"]):
        return tp.embedding(tokens, params["embed"]).to(torch.bfloat16)
    return F.embedding(tokens.long(), params["embed"]).to(torch.bfloat16)


def _embed_inputs(params, cfg, batch: dict):
    """The bf16 stream (qwen2-vl: the patch embeddings, then the tokens')
    and the rotary tables of its positions (M-RoPE for qwen2-vl; none for
    the ssm family)."""
    tokens = batch["tokens"]
    x = _embed(params, tokens)
    B, S = tokens.shape
    if cfg.family == "vlm":
        x = torch.cat([batch["vision_embeds"].to(torch.bfloat16), x], dim=1)
        pos3 = mrope_positions(cfg.vision_patches, S, B, device=x.device)
        return x, dict(rope=mrope_tables(pos3, cfg.head_dim, cfg.rope_theta))
    if cfg.family == "ssm":
        return x, {}
    pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return x, dict(rope=rope_tables(pos, cfg.head_dim, cfg.rope_theta))


def _logits(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the vocabulary projection, a bf16 product as in
    JAX."""
    x = rms_norm(x, params["ln_f"].float(), cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(x.dtype)
    return tp.matmul(x, head)


def _dense(lp, x, cfg, pos_info):
    return dense_block(lp, x, cfg, pos_info=pos_info)[0]


def _moe(lp, x, cfg, pos_info):
    y, _, aux = moe_block(lp, x, cfg, pos_info=pos_info)
    return y, aux


def _ssm(lp, x, cfg):
    return x + mamba2_forward(lp["mamba"],
                              rms_norm(x, lp["ln"], cfg.norm_eps), cfg)


def _superblock(sb, shared, x, cfg, pos_info):
    """zamba2: ``shared_attn_period`` mamba2 layers, then the shared
    attention block (its own norm, no MLP)."""
    for lp in sb:
        x = _ssm(lp, x, cfg)
    h, _ = attn_forward(shared["attn"],
                        rms_norm(x, shared["ln"], cfg.norm_eps),
                        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                        head_dim=cfg.head_dim, rope=pos_info["rope"])
    return x + h


def _decoder(lp, x, enc, cfg, pos_info):
    kv = encdec.cross_kv(lp, enc, cfg)
    return encdec.dec_block(lp, x, cfg, kv_cross=kv, pos_info=pos_info)[0]


def _encode(params, cfg, enc_embeds: torch.Tensor, run):
    """whisper's encoder over the frame embeddings, then ``enc_ln``."""
    enc = enc_embeds.to(torch.bfloat16)
    rope = encdec.enc_tables(enc, cfg)
    for lp in params["encoder"]:
        enc = run(encdec.enc_block, lp, enc, cfg, rope)
    return rms_norm(enc, params["enc_ln"].float(), cfg.norm_eps)


def forward(params, cfg, batch: dict, *, last_only: bool = False,
            remat: bool = False):
    """Teacher-forced forward: batch["tokens"] (B, S) (whisper: and
    ``enc_embeds`` (B, S_enc, d); qwen2-vl: ``vision_embeds`` (B, P, d)
    before the tokens) -> (logits (B, S, V) bf16 (qwen2-vl: P + S
    positions), aux: the MoE load-balance loss summed over the layers, 0
    for the other families). ``last_only`` projects the final position only
    (the prefill path). Attention runs ``flash_attention`` and a mamba2
    layer's scan ``ssd`` (each its autograd Function when grad is on).
    ``remat`` checkpoints each layer (zamba2: each superblock;
    ``torch.utils.checkpoint``, non-reentrant): its activations are
    recomputed in the backward, the counterpart of JAX's
    ``jax.checkpoint(nothing_saveable)`` around each scanned layer. The
    recompute runs under the registry policy of the forward."""
    require_supported(cfg)
    x, pos_info = _embed_inputs(params, cfg, batch)
    policy = registry.policy()

    def contexts():
        return contextlib.nullcontext(), registry.use(policy)

    def run(fn, *args):
        if remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=contexts)
        return fn(*args)

    aux = torch.zeros((), device=x.device)
    fam = cfg.family
    if fam in ("dense", "vlm"):
        for lp in params["layers"]:
            x = run(_dense, lp, x, cfg, pos_info)
    elif fam == "moe":
        if cfg.first_layer_dense:       # outside JAX's scan: no remat
            x = _dense(params["dense0"], x, _dense0_cfg(cfg), pos_info)
        for lp in params["layers"]:
            x, a = run(_moe, lp, x, cfg, pos_info)
            aux = aux + a
    elif fam == "ssm":
        for lp in params["layers"]:
            x = run(_ssm, lp, x, cfg)
    elif fam == "hybrid":
        for sb in params["layers"]:
            x = run(_superblock, sb, params["shared"], x, cfg, pos_info)
    else:                                                   # audio
        enc = _encode(params, cfg, batch["enc_embeds"], run)
        for lp in params["layers"]:
            x = run(_decoder, lp, x, enc, cfg, pos_info)
    if last_only:
        x = x[:, -1:]
    return _logits(params, cfg, x), aux


def loss_fn(params, cfg, batch: dict, *, remat: bool = False,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token cross entropy of the logits against batch["labels"]
    (B, S), the counterpart of ``repro.models.transformer.loss_fn``: the
    bf16 logits upcast to float32 (qwen2-vl: the text tail only),
    logsumexp minus the gold logit, the mean over tokens, plus
    ``aux_weight`` times the aux loss (MoE; 0 for the other families).
    Logits split over the model axis (the dense family's tensor
    parallelism) take DTensor's vocab-parallel cross entropy
    (``tp.cross_entropy``, called and differentiated inside
    ``tp.loss_context``), and the loss is this rank's plain scalar."""
    logits, aux = forward(params, cfg, batch, remat=remat)
    if tp.is_tp(logits):
        return tp.cross_entropy(logits, batch["labels"]) + aux_weight * aux
    if cfg.family == "vlm":
        logits = logits[:, cfg.vision_patches:]
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return (logz - gold).mean() + aux_weight * aux


def _kv(shape, dtype, device) -> dict:
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device))


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None, enc_len: Optional[int] = None) -> dict:
    """Decode cache: ``pos`` (scalar int32) and, by family:

    * dense, vlm: ``layers`` k/v (n_layers, batch, max_len, Hkv, Dh);
    * moe: the same over the MoE layers, and deepseek's ``dense0`` k/v
      (batch, max_len, Hkv, Dh);
    * ssm: the recurrent ``conv`` (n_layers, batch, K-1, conv channels) and
      ``ssm`` (n_layers, batch, H, P, N), float32 zeros whatever ``dtype``,
      as in JAX;
    * hybrid: those leaves (n_super, period, ...), and ``shared`` k/v
      (n_super, batch, max_len, Hkv, Dh), one a superblock;
    * audio: ``layers`` k/v as dense, and ``cross`` k/v (n_layers, batch,
      ``enc_len`` (default max_len), Hkv, Dh), which
      :func:`prefill_audio_cache` fills.
    """
    require_supported(cfg)
    cache = dict(pos=torch.zeros((), dtype=torch.int32, device=device))
    kv = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    fam = cfg.family
    if fam in ("dense", "vlm", "moe", "audio"):
        n = cfg.n_layers - int(fam == "moe" and cfg.first_layer_dense)
        cache["layers"] = _kv((n, *kv), dtype, device)
        if fam == "moe" and cfg.first_layer_dense:
            cache["dense0"] = _kv(kv, dtype, device)
        if fam == "audio":
            cache["cross"] = _kv((cfg.n_layers, batch, enc_len or max_len,
                                  cfg.n_kv_heads, cfg.head_dim), dtype,
                                 device)
        return cache
    st = init_mamba2_state(batch, cfg.d_model, cfg, device=device)
    if fam == "ssm":
        lead = (cfg.n_layers,)
    else:
        lead = (_n_super(cfg), cfg.shared_attn_period)
        cache["shared"] = _kv((_n_super(cfg), *kv), dtype, device)
    cache["layers"] = {k: v.expand(*lead, *v.shape).clone()
                       for k, v in st.items()}
    return cache


def _at(tree: dict, *idx) -> dict:
    return {name: leaf[idx] for name, leaf in tree.items()}


def _mamba_step(lp, x, st: dict, cfg):
    """One mamba2 layer's decode step; its conv window and state written
    into ``st``'s leaves in place."""
    h, new = mamba2_decode_step(lp["mamba"],
                                rms_norm(x, lp["ln"], cfg.norm_eps), st, cfg)
    for name, leaf in st.items():
        leaf.copy_(new[name])
    return x + h


#: page size of a slot cache's page view (see :func:`decode_step`): a slot
#: row read at per-row positions goes through the ``paged_attention`` op as
#: pages of this many rows, so the slot engine takes the paged engine's
#: arithmetic at this page size. ``serve.CachePool`` rounds its rows up to a
#: multiple of it.
SLOT_PAGE = 16


def slot_rows(max_len: int, ranks: int = 1) -> int:
    """The rows a slot cache of depth ``max_len`` holds: ``max_len``
    rounded up to a whole :data:`SLOT_PAGE` on each of ``ranks`` ranks
    that split the rows (rows past ``max_len`` are never read)."""
    unit = SLOT_PAGE * ranks
    return -(-int(max_len) // unit) * unit


def _slot_view(cache: dict, fam: str, B: int):
    """A slot cache's K/V leaves (..., B, Smax, Hkv, Dh) viewed as a page
    pool (..., B * Smax / SLOT_PAGE, SLOT_PAGE, Hkv, Dh) — the same storage,
    no copy — with the identity page table (B, Smax / SLOT_PAGE) int32."""
    groups = ("shared",) if fam == "hybrid" else ("layers", "dense0")
    Smax = cache[groups[0]]["k"].shape[-3]
    if Smax % SLOT_PAGE:
        raise ValueError(
            f"a slot cache read at per-row positions holds whole pages of "
            f"{SLOT_PAGE} rows; got {Smax} (allocate slot_rows(max_len), as "
            f"serve.CachePool does)")
    npg = Smax // SLOT_PAGE
    view = dict(cache)
    for g in groups:
        if g in cache:
            view[g] = dict(cache[g], **{
                n: leaf.view(*leaf.shape[:-4], B * npg, SLOT_PAGE,
                             *leaf.shape[-2:])
                for n, leaf in cache[g].items() if n in ("k", "v")})
    dev = cache[groups[0]]["k"].device
    table = torch.arange(B * npg, dtype=torch.int32, device=dev).view(B, npg)
    return view, table


def decode_step(params, cfg, cache: dict, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None,
                shard: Optional[tp.RowShard] = None):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache).

    positions: optional (B,) int32 per-slot decode depths (the
    continuous-batching engine): each row RoPEs at its own position and
    writes its K/V at its own index; ``cache["pos"]`` is then only
    advanced. Default: the scalar ``cache["pos"]`` shared by the batch.
    qwen2-vl broadcasts the position to all three M-RoPE streams, as JAX
    does (it does not continue from the forward's text positions).
    page_table: optional (B, pages_per_slot) int32 — the attention K/V
    leaves are a paged pool (``repro_torch.serve.paging``): every layer's
    K/V, deepseek's ``dense0``, zamba2's shared-attention K/V and whisper's
    self-attention; requires ``positions``. The recurrent leaves (mamba2's
    conv and ssm) and whisper's cross K/V are pageless and stay in the
    slot layout; a pure SSM has nothing to page and raises for a table
    (JAX ignores it; its engine never passes one, nor does the port's).
    A slot cache read at per-row ``positions`` (the engine's slot pool) is
    read the same way on every device: its K/V viewed in place as pages of
    :data:`SLOT_PAGE` rows behind the identity table, so Smax must be a
    multiple of the page (:func:`slot_rows`). The ``paged_attention`` op is
    the kernel on the card and the JAX package's XLA route on the CPU (the
    pages gathered, then ``chunked_attention``: the slot decode's bits), so
    a slot engine and a paged engine agree bit for bit on the CPU at any
    page size and on the card at a page of :data:`SLOT_PAGE`.

    The cache's tensors are written in place (see
    ``repro_torch.models.blocks``); ``cache["pos"]`` is replaced.

    Weights split over the model axis (the dense family's DTensors,
    ``models.tp``): the step runs at per-row positions (the scalar
    ``cache["pos"]`` broadcast when none are given), the slot cache
    through its page view, and returns the logits replicated, a plain
    tensor on every rank. ``shard``: the model group when every K/V row
    block of the cache is split over it, this rank holding rows
    [rank R, (rank + 1) R) of each block of size R (a page's or a slot
    row's rows, ``dist.sharding.cache_shard``), so the attention merges
    the group's partials; None when every rank holds whole blocks.
    Self-attention dispatches ``paged_attention`` (paged, or a slot cache
    at per-row positions) or runs ``chunked_attention`` (a slot cache at
    the scalar ``cache["pos"]``); whisper's cross-attention runs
    ``flash_attention`` at Sq = 1. A mamba2 layer runs
    ``mamba2_decode_step`` (no positions, no pages).
    """
    require_supported(cfg)
    fam = cfg.family
    if page_table is not None and fam == "ssm":
        # the engine keeps a pure SSM in the slot pool (nothing to page)
        raise NotImplementedError(
            f"{cfg.name}: a paged cache holds attention K/V; the ssm "
            f"family's recurrent leaves are pageless")
    if fam == "ssm":
        x = _embed(params, tokens)
        layers = cache["layers"]
        for i, lp in enumerate(params["layers"]):
            x = _mamba_step(lp, x, _at(layers, i), cfg)
        return _logits(params, cfg, x), dict(cache, pos=cache["pos"] + 1)

    split = tp.is_tp(params["embed"])
    with tp.float32_partials() if split else contextlib.nullcontext():
        return _decode(params, cfg, cache, tokens, positions, page_table,
                       shard, split)


def _decode(params, cfg, cache, tokens, positions, page_table, shard,
            split):
    """:func:`decode_step` of the attention families."""
    fam = cfg.family
    B = tokens.shape[0]
    if split and positions is None:
        positions = cache["pos"].expand(B)
    if page_table is not None and positions is None:
        raise ValueError("a paged cache needs per-row positions")
    if positions is None:
        pos = cache["pos"]
        rope_pos = pos.expand(B).reshape(B, 1)
    else:
        pos = positions
        rope_pos = positions[:, None]
    out_cache = cache
    slot = page_table is None and positions is not None
    if slot:
        cache, page_table = _slot_view(cache, fam, B)
    x = _embed(params, tokens)
    # what every layer of the step shares, computed once: the rotary
    # tables and, paged, the pool rows written and the valid lengths
    if fam == "vlm":
        tables = mrope_tables(rope_pos.expand(3, B, 1), cfg.head_dim,
                              cfg.rope_theta)
    else:
        tables = rope_tables(rope_pos, cfg.head_dim, cfg.rope_theta)
    pos_info = dict(rope=tables)
    layers = cache["layers"]
    if page_table is not None:
        kv = cache["shared"] if fam == "hybrid" else layers
        rows = kv["k"].shape[2]
        if shard is None:
            pos_info["rows"] = paged_rows(page_table, pos, rows)
        else:
            # the rank's rows of each block: of a slot row, a run of
            # whole pages; of a pool page, a slice of its rows
            base = shard.rank * (page_table.shape[1] * rows if slot
                                 else rows)
            pos_info["rows"] = paged_rows(
                page_table, pos, rows,
                stride=rows if slot else rows * shard.size, base=base,
                shard=shard)

    if fam == "moe" and cfg.first_layer_dense:
        x, _ = dense_block(params["dense0"], x, _dense0_cfg(cfg),
                           pos_info=pos_info, cache=cache["dense0"],
                           cache_pos=pos, page_table=page_table)
    for i, lp in enumerate(params["layers"]):
        if fam in ("dense", "vlm"):
            x, _ = dense_block(lp, x, cfg, pos_info=pos_info,
                               cache=_at(layers, i), cache_pos=pos,
                               page_table=page_table)
        elif fam == "moe":
            x, _, _ = moe_block(lp, x, cfg, pos_info=pos_info,
                                cache=_at(layers, i), cache_pos=pos,
                                page_table=page_table)
        elif fam == "audio":
            cross = (cache["cross"]["k"][i], cache["cross"]["v"][i])
            x, _ = encdec.dec_block(lp, x, cfg, kv_cross=cross,
                                    pos_info=pos_info, cache=_at(layers, i),
                                    cache_pos=pos, page_table=page_table)
        else:                                               # hybrid
            for j, sp in enumerate(lp):
                x = _mamba_step(sp, x, _at(layers, i, j), cfg)
            shared = params["shared"]
            h, _ = attn_forward(
                shared["attn"], rms_norm(x, shared["ln"], cfg.norm_eps),
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope=tables,
                cache=_at(cache["shared"], i), cache_pos=pos,
                page_table=page_table, rows=pos_info.get("rows"))
            x = x + h
    return tp.local(_logits(params, cfg, x)), dict(out_cache,
                                                   pos=out_cache["pos"] + 1)


def prefill_audio_cache(params, cfg, cache: dict,
                        enc_embeds: torch.Tensor) -> dict:
    """Run whisper's encoder over ``enc_embeds`` (B, S_enc, d) and fill
    every decoder layer's cross-attention K/V: returns the cache with
    ``cross`` k/v (n_layers, B, S_enc, Hkv, Dh) in the cache's dtype."""
    if cfg.family != "audio":
        raise ValueError(f"{cfg.name}: prefill_audio_cache is whisper's "
                         f"(family 'audio'), not {cfg.family!r}'s")
    enc = _encode(params, cfg, enc_embeds, lambda fn, *a: fn(*a))
    ks, vs = zip(*(encdec.cross_kv(lp, enc, cfg) for lp in params["layers"]))
    dtype = cache["cross"]["k"].dtype
    return dict(cache, cross=dict(k=torch.stack(ks).to(dtype),
                                  v=torch.stack(vs).to(dtype)))


__all__ = ["init_params", "param_count", "forward", "loss_fn", "init_cache",
           "decode_step", "prefill_audio_cache", "require_supported"]

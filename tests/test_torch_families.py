"""The port's other four model families against the JAX package's, at the
smoke config, on the same weights (carried across by ``params_from_numpy``)
and the same numpy inputs: MoE (granite, deepseek: the routing, the
combine's custom backward, the GShard aux), hybrid zamba2 (mamba2
superblocks with one shared attention block), qwen2-vl (M-RoPE over a
vision prefix) and whisper (the encoder-decoder, the cross K/V prefill):
``forward``, ``loss_fn`` and its grads, ``decode_step`` and
``prefill_audio_cache``, the layers each family brings (``moe_ffn``,
``mrope_tables``, ``gelu_mlp``), the parameter counts of the published
configs, and the CLIs. JAX runs on the CPU with its XLA backend, as its own
tests run these checks; the port runs its plain versions."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels import registry as jregistry
from repro.models import decode_step as j_decode_step
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.models import param_count as j_param_count
from repro.models.frontend import mrope_positions as j_mrope_positions
from repro.models.layers import apply_mrope as j_apply_mrope
from repro.models.mlp import gelu_mlp as j_gelu_mlp
from repro.models.moe import init_moe as j_init_moe, moe_ffn as j_moe_ffn
from repro.models.transformer import forward as j_forward
from repro.models.transformer import prefill_audio_cache as j_prefill
import repro.models.transformer as jtransformer
import repro_torch.configs as tconfigs
import repro_torch.models.transformer as ttransformer
from repro_torch.kernels import registry
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.serve import PagedCachePool
from repro_torch.models import (decode_step, forward, init_cache, init_params,
                                loss_fn, param_count, params_from_numpy,
                                prefill_audio_cache)
from repro_torch.models.frontend import mrope_positions
from repro_torch.models.layers import apply_rope, mrope_tables
from repro_torch.models.mlp import gelu, gelu_mlp
from repro_torch.models.moe import moe_ffn, route
from repro_torch.tree import leaves

from _torch_port import to_torch_config_arch

#: the JAX package's own tolerance for teacher-forced logits
#: (tests/test_models.py): bf16 activations through every layer
LOGIT_TOL = dict(atol=0.05, rtol=0.05)
#: bf16 elementwise results: one rounding apart at most, 2^-8 relative
BF16_TOL = dict(atol=1e-2, rtol=8e-3)
#: the JAX package's grad tolerance for two bf16 computations of one
#: gradient (tests/test_torch_train.py, from tests/test_train.py)
GRAD_TOL = dict(atol=5e-3, rtol=5e-2)
#: loss: a mean over thousands of bf16 logits the two frameworks round at
#: other points; about one bf16 step (tests/test_torch_train.py)
SCALAR_RTOL = 5e-3
ARCHS = ["granite-moe-1b-a400m", "deepseek-moe-16b", "zamba2-2.7b",
         "qwen2-vl-2b", "whisper-medium"]
MOE = ["granite-moe-1b-a400m", "deepseek-moe-16b"]
B, S, ENC = 2, 12, 20


def _np(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _f32(a):
    return np.asarray(a, np.float32)


def _t(a):
    return a.detach().float().numpy()


@functools.lru_cache(maxsize=None)
def _model(name, capacity_factor=None):
    """(JAX cfg, port cfg, JAX float32 weights), once per module, arch and
    capacity factor."""
    cfg = jconfigs.smoke_config(jconfigs.get_arch(name))
    if capacity_factor is not None:
        cfg = cfg.scaled(capacity_factor=capacity_factor)
    return cfg, to_torch_config_arch(cfg), j_init_params(
        cfg, jax.random.PRNGKey(0))


def _port(tcfg, jp, dtype=torch.bfloat16):
    return params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                             device="cpu", dtype=dtype)


def _batch(cfg, seed=0, seq=S, batch=B):
    """numpy inputs of one family: tokens and labels (batch, seq);
    whisper's frame embeddings (batch, ENC, d), qwen2-vl's patch embeddings
    (batch, P, d)."""
    rng = np.random.default_rng(seed)
    shape = (batch, seq)
    b = dict(tokens=rng.integers(0, cfg.vocab, shape).astype(np.int32),
             labels=rng.integers(0, cfg.vocab, shape).astype(np.int32))
    if cfg.family == "audio":
        b["enc_embeds"] = rng.standard_normal(
            (batch, ENC, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.standard_normal(
            (batch, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    return b


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------------- moe --
def _moe_inputs(name, seed=0, Sq=16):
    cfg = jconfigs.smoke_config(jconfigs.get_arch(name))
    shared = cfg.moe_d_ff * cfg.n_shared_experts
    jp = j_init_moe(jax.random.PRNGKey(seed), cfg.d_model, cfg.moe_d_ff,
                    cfg.n_experts, cfg.n_shared_experts, shared)
    x = _np(seed + 1, (B, Sq, cfg.d_model))
    return cfg, jp, x


def _j_route(params, x, top_k, capacity_factor):
    """JAX's routing decisions, as ``repro.models.moe.moe_ffn`` makes them
    (it does not return them): (gates, sel, keep)."""
    Bx, Sx, _ = x.shape
    E = params["router"].shape[1]
    C = max(int(Sx * top_k / E * capacity_factor), 4)
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                        params["router"].astype(jnp.float32))
    gates = jax.nn.softmax(logits, axis=-1)
    _, sel = jax.lax.top_k(gates, top_k)
    flat = jax.nn.one_hot(sel, E, dtype=jnp.int32).reshape(Bx, Sx * top_k, E)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos_tok = (pos * flat).sum(-1).reshape(Bx, Sx, top_k)
    return gates, sel, pos_tok < C


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_ffn_matches_jax(name, capacity_factor):
    """The routing (sel, keep) equal to JAX's, with tokens dropped (cf 0.5
    drops some), and the output and aux loss at the bf16 tolerance. Where
    the routing differs, the smallest gap between the k-th and (k+1)-th
    gate is printed: a near tie is not a fault."""
    cfg, jp, x = _moe_inputs(name)
    kw = dict(top_k=cfg.top_k, capacity_factor=capacity_factor)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, waux = jax.jit(lambda p, x: j_moe_ffn(p, x, **kw))(jp, xb)
    gates, jsel, jkeep = jax.jit(
        lambda p, x: _j_route(p, x, **kw))(jp, xb)
    tp = jax.tree.map(lambda a: torch.from_numpy(_f32(a)), jp)
    xt = torch.from_numpy(x).bfloat16()
    got, aux = moe_ffn(tp, xt, **kw)
    _, _, sel, _, keep, _ = route(tp, xt, **kw)
    g = np.sort(_f32(gates), axis=-1)[..., ::-1]
    gap = float((g[..., cfg.top_k - 1] - g[..., cfg.top_k]).min())
    same = (np.array_equal(sel.numpy(), np.asarray(jsel))
            and np.array_equal(keep.numpy(), np.asarray(jkeep)))
    assert same, f"routing differs; smallest k-th/(k+1)-th gate gap {gap:.3e}"
    if capacity_factor < 1:
        assert not keep.all()                  # some tokens were dropped
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_t(got), _f32(want), **BF16_TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


@pytest.mark.parametrize("name", MOE)
def test_moe_grads_match_jax(name):
    """Grads through the combine's custom backward (the scatter-add of
    dout·w, the gathered inner products), the dispatch, the router and the
    aux loss, against ``jax.grad``, with tokens dropped, at GRAD_TOL, in a
    float32 stream, where nothing but the order of float32 sums tells the
    two apart. The bf16 stream's MoE grads are held at the model level
    (:func:`test_loss_and_grads_match_jax`, granite and deepseek): at this
    layer alone an expert's ``w_gate`` grad, a sum over the buffer's rows,
    differs past GRAD_TOL in a few elements, since the port's silu
    backward is autograd's of XLA's forward expression and JAX rounds its
    own rule (ROADMAP queue 3)."""
    cfg, jp, x = _moe_inputs(name, seed=3)
    kw = dict(top_k=cfg.top_k, capacity_factor=0.75)
    ct = _np(7, (B, 16, cfg.d_model))

    def j_obj(p, x):
        out, aux = j_moe_ffn(p, x, **kw)
        return (out * ct).sum() + 10.0 * aux

    jg, jgx = jax.jit(jax.grad(j_obj, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.from_numpy(_f32(a)).requires_grad_(),
                      jp)
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe_ffn(tp, xt, **kw)
    _, _, _, _, keep, _ = route(tp, xt, **kw)
    assert not keep.all()                      # some tokens were dropped
    obj = (out * torch.from_numpy(ct)).sum() + 10.0 * aux
    grads = torch.autograd.grad(obj, jax.tree.leaves(tp) + [xt])
    for i, (g, w) in enumerate(zip(grads, jax.tree.leaves(jg) + [jgx])):
        np.testing.assert_allclose(_t(g), _f32(w), err_msg=f"leaf {i}",
                                   **GRAD_TOL)


def test_moe_matches_dense_reference_at_full_capacity():
    """The port's copy of the JAX package's
    ``test_moe_matches_dense_reference_at_full_capacity``: the scatter /
    gather MoE with the custom-backward combine equals the all-experts
    einsum reference when nothing is dropped, forward and grads, in
    float32, at the reference's tolerances."""
    Bx, Sx, d, E, k_top, ff = 2, 16, 32, 4, 2, 64
    jp = j_init_moe(jax.random.PRNGKey(0), d, ff, E, 0, 0)
    x = torch.from_numpy(_f32(jax.random.normal(jax.random.PRNGKey(1),
                                                (Bx, Sx, d))))
    params = {k: torch.from_numpy(_f32(v)) for k, v in jp.items()}

    def dense_ref(p, x):
        gates = torch.softmax(x @ p["router"], -1)
        w, sel = torch.topk(gates, k_top)
        w = w / w.sum(-1, keepdim=True)
        mask = (torch.nn.functional.one_hot(sel, E) * w[..., None]).sum(2)
        h = torch.einsum("bsd,edf->bsef", x, p["w_gate"])
        h = torch.nn.functional.silu(h) * torch.einsum("bsd,edf->bsef", x,
                                                       p["w_up"])
        y = torch.einsum("bsef,efd->bsed", h, p["w_down"])
        return (y * mask[..., None]).sum(2)

    def opt_path(p, x):
        return moe_ffn(p, x, top_k=k_top, capacity_factor=8.0)[0]

    np.testing.assert_allclose(_t(opt_path(params, x)),
                               _t(dense_ref(params, x)), atol=2e-5)
    grads = []
    for fn in (dense_ref, opt_path):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        (fn(p, x) ** 2).sum().backward()
        grads.append([p[k].grad for k in sorted(p)])
    for a, b in zip(*grads):
        np.testing.assert_allclose(_t(b), _t(a), atol=5e-4)


# ---------------------------------------------------------- M-RoPE, GeLU --
@pytest.mark.parametrize("n_patches,text_len,grid_w",
                         [(16, 12, None), (1024, 512, None), (10, 3, 3),
                          (0, 5, None)])
def test_mrope_positions_equal_jax(n_patches, text_len, grid_w):
    want = j_mrope_positions(n_patches, text_len, 2, grid_w)
    got = mrope_positions(n_patches, text_len, 2, grid_w)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("head_dim,theta", [(16, 1e4), (128, 1e6),
                                            (24, 1e4)])
def test_mrope_tables_match_apply_mrope(head_dim, theta):
    """``apply_rope`` through ``mrope_tables`` against ``apply_mrope``:
    the sections' bounds (24: half = 12 splits 6/3/3; 16: 4/2/2) and each
    frequency's own position stream, float32 and bf16."""
    x = _np(0, (2, 37, 4, head_dim))
    pos = np.asarray(j_mrope_positions(25, 12, 2))
    pos = pos + np.random.default_rng(1).integers(0, 50, pos.shape).astype(
        np.int32)
    tables = mrope_tables(torch.from_numpy(pos), head_dim, theta)
    want = j_apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta=theta)
    got = apply_rope(torch.from_numpy(x), None, tables=tables)
    np.testing.assert_allclose(_t(got), _f32(want), atol=2e-5, rtol=2e-5)
    wb = j_apply_mrope(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos),
                       theta=theta)
    gb = apply_rope(torch.from_numpy(x).bfloat16(), None, tables=tables)
    np.testing.assert_allclose(_t(gb), _f32(wb), **BF16_TOL)


def test_gelu_matches_jax_bits_and_gelu_mlp_matches_jax():
    """``gelu`` has ``jax.nn.gelu``'s rounding points: the same bf16 bits on
    2^20 inputs drawn N(0, 9), where ``F.gelu(approximate="tanh")``, one
    rounding, differs in 42.55% of them (the share ``gelu``'s docstring
    states); ``gelu_mlp`` at the bf16 tolerance."""
    v = 3 * _np(0, (1 << 20,))
    want = _f32(jax.nn.gelu(jnp.asarray(v).astype(jnp.bfloat16)))
    xb = torch.from_numpy(v).bfloat16()
    np.testing.assert_array_equal(_t(gelu(xb)), want)
    once = torch.nn.functional.gelu(xb, approximate="tanh")
    assert round(100 * float((_t(once) != want).mean()), 2) == 42.55
    w = {k: 0.1 * _np(i, s) for i, (k, s) in enumerate(
        [("w_in", (64, 128)), ("b_in", (128,)), ("w_out", (128, 64)),
         ("b_out", (64,))])}
    x = _np(9, (2, 5, 64))
    want = j_gelu_mlp({k: jnp.asarray(a) for k, a in w.items()},
                      jnp.asarray(x).astype(jnp.bfloat16))
    got = gelu_mlp({k: torch.from_numpy(a) for k, a in w.items()},
                   torch.from_numpy(x).bfloat16())
    np.testing.assert_allclose(_t(got), _f32(want), **BF16_TOL)


# ----------------------------------------------------------------- params --
@pytest.mark.parametrize("name", ARCHS)
def test_params_carry_across(name):
    """``params_from_numpy`` takes every family's tree: the counts equal,
    zamba2's layers (n_super, period) as nested lists, whisper's encoder,
    the unstacked entries; the router and mamba2's decay in float32."""
    cfg, tcfg, jp = _model(name)
    tp = _port(tcfg, jp)
    assert param_count(tp) == j_param_count(jp)
    if cfg.family == "hybrid":
        n_super = cfg.n_layers // cfg.shared_attn_period
        assert len(tp["layers"]) == n_super
        assert all(len(sb) == cfg.shared_attn_period for sb in tp["layers"])
        m = tp["layers"][1][0]["mamba"]
        assert m["A_log"].dtype == m["dt_bias"].dtype == torch.float32
        np.testing.assert_array_equal(
            m["dt_bias"].numpy(), _f32(jp["layers"]["mamba"]["dt_bias"][1, 0]))
        assert set(tp["shared"]) == {"ln", "attn"}
    elif cfg.family == "moe":
        lp = tp["layers"][0]["moe"]
        assert lp["router"].dtype == torch.float32
        assert lp["w_gate"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            lp["router"].numpy(), _f32(jp["layers"]["moe"]["router"][0]))
        assert ("dense0" in tp) == cfg.first_layer_dense
    elif cfg.family == "audio":
        assert len(tp["encoder"]) == cfg.n_enc_layers
        assert len(tp["layers"]) == cfg.n_layers
        assert tp["enc_ln"].shape == (cfg.d_model,)
    bad = jax.tree.map(np.asarray, jp)
    bad["layers"] = jax.tree.map(lambda a: a[:0], bad["layers"])
    with pytest.raises(ValueError, match="leads with"):
        params_from_numpy(tcfg, bad)


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_shapes_and_seed(name):
    """The port's own init has the JAX tree's every shape, in the port's
    layout; a seed gives the same weights twice."""
    cfg, tcfg, jp = _model(name)
    a = init_params(tcfg, torch.Generator().manual_seed(0))
    b = init_params(tcfg, torch.Generator().manual_seed(0),
                    dtype=torch.bfloat16)
    shapes = [tuple(t.shape) for t in leaves(_port(tcfg, jp))]
    assert [tuple(t.shape) for t in leaves(a)] == shapes
    assert [tuple(t.shape) for t in leaves(b)] == shapes
    assert all(torch.equal(x.to(y.dtype), y) for x, y in
               zip(leaves(a), leaves(b)))
    f32 = {t.dtype for t in leaves(b)} - {torch.bfloat16}
    assert f32 <= {torch.float32}


@pytest.mark.parametrize("name", ARCHS)
def test_param_counts_of_the_full_configs_equal_jax(name):
    """The published config's parameter count, the port's built on the
    ``meta`` device (nothing allocated) against JAX's ``jax.eval_shape``
    of ``init_params``: what chip_smoke.py's phase 15 runs is the
    published width."""
    jcfg = jconfigs.get_arch(name)
    sds = jax.eval_shape(lambda k: j_init_params(jcfg, k),
                         jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(sds))
    params = init_params(tconfigs.get_arch(name), None,
                         dtype=torch.bfloat16, device="meta")
    assert param_count(params) == want


# ------------------------------------------------------------------ model --
@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_jax(name):
    cfg, tcfg, jp = _model(name)
    batch = _batch(cfg)
    with jregistry.use("xla"):
        want, waux = jax.jit(lambda p, b: j_forward(p, cfg, b))(jp,
                                                                _jb(batch))
    registry.reset_dispatch_counts()
    got, aux = forward(_port(tcfg, jp), tcfg, _tb(batch))
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.shared_attn_period
    elif cfg.family == "audio":             # encoder, decoder self, cross
        n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    else:
        n_attn = cfg.n_layers
    counts = registry.dispatch_counts()
    assert counts.get(("flash_attention", "torch")) == n_attn
    if cfg.family == "hybrid":
        assert counts.get(("ssd", "torch")) == cfg.n_layers
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(_t(got), _f32(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=SCALAR_RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_jax(name):
    """``loss_fn`` (MoE: with aux_weight times the aux; qwen2-vl: over the
    text tail) and its grads from float32 weights against JAX's, on the
    batch shape of the port's other grad tests (8 x 16,
    tests/test_torch_train.py). JAX runs its Pallas kernels in interpret
    mode here, whose attention arithmetic (float32 p, the FA-2 backward)
    the port's plain versions carry. Its XLA path rounds p to bf16, and
    JAX's own two paths then differ past GRAD_TOL in some grads (the MoE
    routing splits between them), so the XLA path is no yardstick for the
    port's bf16 grads; in a float32 stream the two models agree to float32
    rounding (:func:`test_float32_stream_matches_jax`)."""
    cfg, tcfg, jp = _model(name)
    batch = _batch(cfg, seed=1, seq=16, batch=8)
    with jregistry.use("pallas"):
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p, b: j_loss_fn(p, cfg, b)))(jp, _jb(batch))
    params = _port(tcfg, jp, torch.float32)
    ps = [t.requires_grad_() for t in leaves(params)]
    loss = loss_fn(params, tcfg, _tb(batch))
    grads = torch.autograd.grad(loss, ps)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=SCALAR_RTOL)
    want = leaves(_port(tcfg, jg, torch.float32))
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_t(g), _t(w), err_msg=f"grad leaf {i}",
                                   **GRAD_TOL)


def _float32_stream(lib):
    """A copy of the array library ``lib`` whose ``bfloat16`` is float32:
    a module that reads its stream dtype from it casts to float32."""
    shim = types.SimpleNamespace(**{k: getattr(lib, k) for k in dir(lib)
                                    if not k.startswith("__")})
    shim.bfloat16 = lib.float32
    return shim


@pytest.mark.parametrize("name", ARCHS)
def test_float32_stream_matches_jax(monkeypatch, name):
    """Both models with their bf16 stream made float32 (the stream's casts
    in the orchestration modules redirected, float32 weights): the loss
    and every grad agree to float32 rounding, normwise 1e-5, with JAX's
    XLA path. What the bf16 tests above leave to their tolerances is then
    rounding, not a difference of structure or of an op."""
    cfg, tcfg, jp = _model(name)
    monkeypatch.setattr(jtransformer, "jnp", _float32_stream(jnp))
    monkeypatch.setattr(ttransformer, "torch", _float32_stream(torch))
    batch = _batch(cfg, seed=1, seq=16, batch=8)
    with jregistry.use("xla"):
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p, b: j_loss_fn(p, cfg, b)))(jp, _jb(batch))
    params = _port(tcfg, jp, torch.float32)
    ps = [t.requires_grad_() for t in leaves(params)]
    loss = loss_fn(params, tcfg, _tb(batch))
    grads = torch.autograd.grad(loss, ps)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    for i, (g, w) in enumerate(zip(grads, leaves(_port(tcfg, jg,
                                                       torch.float32)))):
        err = float((g - w).norm() / w.norm().clamp_min(1e-30))
        assert err <= 1e-5, f"grad leaf {i}: normwise {err:.3e}"


@pytest.mark.parametrize("name", ARCHS)
def test_remat_gives_the_same_bits(name):
    """Checkpointing each layer (each zamba2 superblock, each whisper
    encoder and decoder layer, each MoE layer with its aux) changes no
    number of the loss or the grads."""
    cfg, tcfg, jp = _model(name)
    batch = _tb(_batch(cfg, seed=2))
    out = {}
    for remat in (False, True):
        params = _port(tcfg, jp, torch.float32)
        ps = [t.requires_grad_() for t in leaves(params)]
        loss = loss_fn(params, tcfg, batch, remat=remat)
        out[remat] = (loss, torch.autograd.grad(loss, ps))
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1],
                                                  out[True][1]))


def _j_cache(cfg, jp, batch, max_len):
    jc = j_init_cache(cfg, B, max_len, enc_len=ENC)
    if cfg.family == "audio":
        with jregistry.use("xla"):
            jc = jax.jit(lambda p, c, e: j_prefill(p, cfg, c, e))(
                jp, jc, jnp.asarray(batch["enc_embeds"]))
    return jc


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_jax_and_teacher_forcing(name):
    """8 ``decode_step``s on a slot cache (whisper: after
    ``prefill_audio_cache``) against JAX's decode, and against the port's
    own forward (the JAX package's teacher-forcing check, with the capacity
    factor raised so no token drops; qwen2-vl skipped there, as JAX skips
    it: its decode positions do not continue the vision prefix's)."""
    cfg, tcfg, jp = _model(name, capacity_factor=8.0)
    tp = _port(tcfg, jp)
    steps = 8
    batch = _batch(cfg, seed=3, seq=steps)
    toks = batch["tokens"]
    jc, tc = _j_cache(cfg, jp, batch, 16), init_cache(tcfg, B, 16,
                                                       enc_len=ENC)
    if cfg.family == "audio":
        tc = prefill_audio_cache(tp, tcfg, tc,
                                 torch.from_numpy(batch["enc_embeds"]))
    step = jax.jit(lambda p, c, tok: j_decode_step(p, cfg, c, tok))
    outs_j, outs_t = [], []
    for t in range(steps):
        with jregistry.use("xla"):
            lj, jc = step(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        lt, tc = decode_step(tp, tcfg, tc, torch.from_numpy(toks[:, t:t + 1]))
        outs_j.append(_f32(lj[:, 0]))
        outs_t.append(_t(lt[:, 0]))
    dec = np.stack(outs_t, 1)
    np.testing.assert_allclose(dec, np.stack(outs_j, 1), **LOGIT_TOL)
    assert int(tc["pos"]) == steps
    if cfg.family == "vlm":
        return
    tf, _ = forward(tp, tcfg, _tb(batch))
    np.testing.assert_allclose(dec, _t(tf), **LOGIT_TOL)


def test_decode_with_per_row_positions_matches_jax():
    """The MoE decode at a depth per row (the engine's layout) against
    JAX's."""
    cfg, tcfg, jp = _model("granite-moe-1b-a400m")
    tp = _port(tcfg, jp)
    toks = _batch(cfg, seed=4, seq=5)["tokens"]
    jc, tc = j_init_cache(cfg, B, 16), init_cache(tcfg, B, 16)
    step = jax.jit(lambda p, c, tok, pos: j_decode_step(p, cfg, c, tok,
                                                        positions=pos))
    for t in range(5):
        pos = np.asarray([t, t + 3], np.int32)
        with jregistry.use("xla"):
            lj, jc = step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                          jnp.asarray(pos))
        lt, tc = decode_step(tp, tcfg, tc, torch.from_numpy(toks[:, t:t + 1]),
                             positions=torch.from_numpy(pos))
        np.testing.assert_allclose(_t(lt), _f32(lj), **LOGIT_TOL)


def test_prefill_audio_cache_matches_jax():
    """whisper's encoder and every layer's cross K/V against JAX's, in the
    cache's dtype, at the encoder length of the frames given."""
    cfg, tcfg, jp = _model("whisper-medium")
    batch = _batch(cfg, seed=5)
    jc = _j_cache(cfg, jp, batch, 16)
    tc = prefill_audio_cache(_port(tcfg, jp), tcfg,
                             init_cache(tcfg, B, 16, enc_len=4),
                             torch.from_numpy(batch["enc_embeds"]))
    for name in ("k", "v"):
        got, want = tc["cross"][name], jc["cross"][name]
        assert got.dtype == torch.bfloat16
        assert tuple(got.shape) == tuple(want.shape) == (
            cfg.n_layers, B, ENC, cfg.n_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(_t(got), _f32(want), **LOGIT_TOL)


def test_paged_decode_of_the_other_families_raises():
    """Once refused, now served: a paged ``decode_step`` of every family of
    this file (deepseek's dense first layer, zamba2's shared attention,
    whisper's self-attention beside its slot cross K/V, qwen2-vl's M-RoPE)
    gives the slot cache's logits bit for bit on the CPU (both read through
    the chunked attention), and only a page table without per-row positions
    raises, or a slot cache read at per-row positions whose rows are not
    whole pages of the slot view."""
    P, steps = 4, 6
    for name in ARCHS:
        cfg, tcfg, jp = _model(name)
        tp = _port(tcfg, jp)
        pool = PagedCachePool(tcfg, B, 16, page_size=P, enc_len=ENC,
                              device="cpu")
        paged = pool.make_cache()
        slot = init_cache(tcfg, B, 16, enc_len=ENC)
        batch = _batch(cfg, seed=7, seq=steps)
        if cfg.family == "audio":
            slot = prefill_audio_cache(tp, tcfg, slot,
                                       torch.from_numpy(batch["enc_embeds"]))
            paged["cross"] = {n: t.clone() for n, t in slot["cross"].items()}
        for b in range(B):
            pool.allocate(f"r{b}")
            pool.reserve(b, 16)
        table = torch.from_numpy(pool.tables.copy())
        for t in range(steps):
            tok = torch.from_numpy(batch["tokens"][:, t:t + 1])
            pos = torch.full((B,), t, dtype=torch.int32)
            ls, slot = decode_step(tp, tcfg, slot, tok, positions=pos)
            lp, paged = decode_step(tp, tcfg, paged, tok, positions=pos,
                                    page_table=table)
            assert torch.equal(ls, lp), (name, t)
        with pytest.raises(ValueError, match="per-row positions"):
            decode_step(tp, tcfg, paged, tok, page_table=table)
        with pytest.raises(ValueError, match="whole pages"):
            decode_step(tp, tcfg, init_cache(tcfg, B, 15, enc_len=ENC), tok,
                        positions=pos)


# ------------------------------------------------------------------- CLIs --
@pytest.mark.parametrize("name", ARCHS)
def test_classic_serve_cli_runs_every_family(capsys, name):
    """``launch.serve --engine off`` decodes every family (whisper after a
    cross K/V prefill from seeded frames), and the engine serves every
    family too, on the paged pool (whisper: its requests' seeded frames
    prefilled at admission)."""
    out = serve_cli.main(["--device", "cpu", "--arch", name, "--engine",
                          "off", "--batch", "2", "--new-tokens", "3",
                          "--max-len", "16"])
    assert tuple(out.shape) == (2, 3)
    assert f"arch={name}" in capsys.readouterr().out
    out = serve_cli.main(["--device", "cpu", "--arch", name, "--batch", "2",
                          "--new-tokens", "3", "--requests", "3",
                          "--max-len", "16", "--page-size", "4"])
    text = capsys.readouterr().out
    assert "engine=on" in text and "retired=3" in text and "paged:" in text
    assert len(out) == 3 and all(len(r.tokens) == 3 for r in out)


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "zamba2-2.7b"])
def test_train_cli_trains_the_token_only_families(tmp_path, name):
    runner = train_cli.main(["--device", "cpu", "--arch", name, "--steps",
                             "2", "--ckpt-every", "1", "--ckpt-dir",
                             str(tmp_path)])
    assert len(runner.metrics_log) == 2
    assert all(np.isfinite(m["loss"]) for m in runner.metrics_log)


@pytest.mark.parametrize("name", ["whisper-medium", "qwen2-vl-2b"])
def test_train_cli_refuses_the_embedding_families(tmp_path, name):
    with pytest.raises(NotImplementedError,
                       match=r"repro_torch\.launch\.grad_smoke"):
        train_cli.main(["--device", "cpu", "--arch", name, "--steps", "1",
                        "--ckpt-dir", str(tmp_path)])

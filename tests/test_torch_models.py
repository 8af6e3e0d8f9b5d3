"""The port's dense and ssm models (the other families:
``tests/test_torch_families.py``) against the JAX package's, on the same
weights (carried across by ``params_from_numpy``) and the same numpy
inputs: the configs, the layers, ``quantize_kv``, ``chunked_attention``,
``forward`` and ``decode_step`` over the slot, paged and int8 paged caches,
and mamba2's block, forward and recurrent decode. JAX runs on the CPU with
its XLA backend, as its own tests run these checks."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels import registry as jregistry
from repro.models import decode_step as j_decode_step, init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import param_count as j_param_count
from repro.models.attention import (chunked_attention as j_chunked,
                                    quantize_kv as j_quantize_kv)
from repro.models.layers import apply_rope as j_rope, rms_norm as j_rms
from repro.models.mlp import swiglu as j_swiglu
from repro.models.ssm import _causal_conv as j_causal_conv
from repro.models.transformer import forward as j_forward
from repro.serve import PagedCachePool as JPagedCachePool
import repro_torch.configs as tconfigs
from repro_torch.kernels import registry
from repro_torch.models import (decode_step, forward, init_cache, init_params,
                                param_count)
from repro_torch.models.attention import attention, chunked_attention, quantize_kv
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.models.mlp import swiglu
from repro_torch.models.ssm import _causal_conv, _softplus
from repro_torch.serve import PagedCachePool

from _torch_port import to_torch_config_arch, to_torch_params

#: the JAX package's own tolerance for teacher-forced logits
#: (tests/test_models.py): bf16 activations through every layer
LOGIT_TOL = dict(atol=0.05, rtol=0.05)
#: bf16 elementwise results: one rounding apart at most, 2^-8 relative
BF16_TOL = dict(atol=1e-2, rtol=8e-3)
ARCH_NAMES = sorted(jconfigs.ARCHS)


def _np(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _f32(a):
    return np.asarray(a, np.float32)


def _t(a):
    return a.float().numpy()


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_config_fields_equal_jax(name):
    jc, tc = jconfigs.get_arch(name), tconfigs.get_arch(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.attn_free, tc.subquadratic) == (jc.attn_free, jc.subquadratic)
    assert dataclasses.asdict(tconfigs.smoke_config(tc)) == \
        dataclasses.asdict(jconfigs.smoke_config(jc))
    for shape in jconfigs.SHAPES:
        assert dataclasses.asdict(tconfigs.SHAPES[shape]) == \
            dataclasses.asdict(jconfigs.SHAPES[shape])
        assert tconfigs.cell_applicable(tc, tconfigs.SHAPES[shape]) == \
            jconfigs.cell_applicable(jc, jconfigs.SHAPES[shape])


# ----------------------------------------------------------------- layers --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    x, g = _np(0, (2, 5, 64)), 1 + 0.1 * _np(1, (64,))
    want = j_rms(jnp.asarray(x).astype(dtype), jnp.asarray(g))
    got = rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                   torch.from_numpy(g))
    # the same rounding points; float32 rsqrt may differ in its last bit
    tol = dict(atol=0, rtol=1e-6) if dtype == "float32" else \
        dict(atol=0, rtol=0)
    np.testing.assert_allclose(_t(got), _f32(want), **tol)


@pytest.mark.parametrize("theta", [1e4, 5e5])       # internlm2, llama3
def test_apply_rope_matches_jax(theta):
    x = _np(0, (2, 7, 4, 16))
    pos = np.random.default_rng(1).integers(0, 2000, (2, 7)).astype(np.int32)
    want = j_rope(jnp.asarray(x), jnp.asarray(pos), theta=theta)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta=theta)
    # float32 sin/cos of angles up to 2000 rad: the two libraries' last bits
    np.testing.assert_allclose(_t(got), _f32(want), atol=2e-5, rtol=2e-5)
    wb = j_rope(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos),
                theta=theta)
    gb = apply_rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos),
                    theta=theta)
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(_t(gb), _f32(wb), **BF16_TOL)


def test_swiglu_matches_jax():
    w = {k: 0.1 * _np(i, s) for i, (k, s) in enumerate(
        [("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64))])}
    x = _np(9, (2, 5, 64))
    want = j_swiglu({k: jnp.asarray(v) for k, v in w.items()},
                    jnp.asarray(x).astype(jnp.bfloat16))
    got = swiglu({k: torch.from_numpy(v) for k, v in w.items()},
                 torch.from_numpy(x).bfloat16())
    # silu with JAX's rounding points; the products may sum in another order
    np.testing.assert_allclose(_t(got), _f32(want), **BF16_TOL)


def test_quantize_kv_matches_jax():
    x = _np(0, (3, 5, 2, 16)) * np.linspace(0.0, 3.0, 5)[None, :, None, None]
    jq, js = j_quantize_kv(jnp.asarray(x))
    tq, ts = quantize_kv(torch.from_numpy(x).bfloat16().float())
    jq2, js2 = j_quantize_kv(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js2))
    tq, ts = quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[:, 0].min()) == 1.0            # all-zero rows: scale 1


@pytest.mark.parametrize("case", ["scalar_valid", "row_valid", "causal",
                                  "q_blocks"])
def test_chunked_attention_matches_jax(case):
    B, S, Skv = 3, 8, 40
    kw, kv_len = {}, None
    if case == "scalar_valid":
        kv_len, S = 17, 1
    elif case == "row_valid":
        kv_len, S = np.asarray([1, 23, 40], np.int32), 1
    elif case == "q_blocks":
        S, Skv, kw = 32, 32, dict(q_chunk=8, chunk=16)
    q, k, v = _np(1, (B, S, 4, 16)), _np(2, (B, Skv, 2, 16)), \
        _np(3, (B, Skv, 2, 16))
    causal = kv_len is None
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = jax.jit(lambda q, k, v, n: j_chunked(
        q, k, v, causal=causal, kv_valid_len=n, **kw))(
            *jb, None if kv_len is None else jnp.asarray(kv_len))
    got = chunked_attention(*(torch.from_numpy(a).bfloat16() for a in
                              (q, k, v)), causal=causal,
                            kv_valid_len=None if kv_len is None
                            else torch.as_tensor(kv_len), **kw)
    # the XLA path's arithmetic, op for op
    np.testing.assert_allclose(_t(got), _f32(want), **BF16_TOL)


def test_attention_routes_kv_valid_len_to_chunked():
    q = torch.from_numpy(_np(0, (2, 1, 4, 16)))
    k = torch.from_numpy(_np(1, (2, 9, 2, 16)))
    registry.reset_dispatch_counts()
    a = attention(q, k, k, causal=False, kv_valid_len=torch.tensor([3, 9]))
    assert registry.dispatch_counts() == {}
    attention(q, k, k, causal=True)
    assert registry.dispatch_counts() == {("flash_attention", "torch"): 1}
    torch.testing.assert_close(a[:1], chunked_attention(
        q[:1], k[:1, :3], k[:1, :3], causal=False))


# ------------------------------------------------------------------ model --
ARCHS = ["internlm2-1.8b", "llama3-8b"]    # llama3: rope_theta 5e5


@functools.lru_cache(maxsize=None)
def _model(name):
    """(JAX cfg, port cfg, JAX weights, the same weights in the port), once
    per module and arch."""
    cfg = jconfigs.smoke_config(jconfigs.get_arch(name))
    params = j_init_params(cfg, jax.random.PRNGKey(0))
    return cfg, to_torch_config_arch(cfg), params, to_torch_params(params,
                                                                   cfg)


@pytest.fixture(params=ARCHS)
def model(request):
    return _model(request.param)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


def test_params_carry_across(model):
    cfg, tcfg, jp, tp = model
    assert param_count(tp) == j_param_count(jp)
    assert len(tp["layers"]) == cfg.n_layers
    np.testing.assert_array_equal(
        _t(tp["layers"][1]["attn"]["wq"]),
        _f32(jnp.asarray(jp["layers"]["attn"]["wq"][1]).astype(
            jnp.bfloat16)))


def test_init_params_shapes_and_seed(model):
    cfg, tcfg, jp, _ = model
    a = init_params(tcfg, torch.Generator().manual_seed(0))
    b = init_params(tcfg, torch.Generator().manual_seed(0))
    assert param_count(a) == j_param_count(jp)
    assert a["lm_head"].shape == jp["lm_head"].shape
    assert a["layers"][0]["mlp"]["w_down"].shape == \
        jp["layers"]["mlp"]["w_down"].shape[1:]
    assert torch.equal(a["embed"], b["embed"])
    # N(0, 1/fan_in): the sample std of the (d, ff) gate is about d^-1/2
    std = float(a["layers"][0]["mlp"]["w_gate"].std())
    assert abs(std * cfg.d_model ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("last_only", [False, True])
def test_forward_matches_jax(model, last_only):
    cfg, tcfg, jp, tp = model
    toks = _tokens(cfg, 2, 12)
    with jregistry.use("xla"):
        want, _ = jax.jit(lambda p, t: j_forward(
            p, cfg, {"tokens": t}, last_only=last_only))(jp, jnp.asarray(toks))
    got, aux = forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                       last_only=last_only)
    assert got.dtype == torch.bfloat16 and float(aux) == 0.0
    np.testing.assert_allclose(_t(got), _f32(want), **LOGIT_TOL)


def _jax_paged(cfg, B, max_len, kv_dtype):
    pool = JPagedCachePool(cfg, B, max_len, page_size=5, kv_dtype=kv_dtype)
    for b in range(B):
        pool.reserve(pool.allocate(f"r{b}"), max_len)
    return pool.make_cache(), jnp.asarray(pool.tables)


def _torch_paged(tcfg, B, max_len, kv_dtype):
    pool = PagedCachePool(tcfg, B, max_len, page_size=5, kv_dtype=kv_dtype,
                          device="cpu")
    for b in range(B):
        pool.reserve(pool.allocate(f"r{b}"), max_len)
    return pool.make_cache(), torch.from_numpy(pool.tables.copy())


@pytest.mark.parametrize("arch,layout", [
    ("internlm2-1.8b", "slot"), ("internlm2-1.8b", "slot_rows"),
    ("internlm2-1.8b", "paged"), ("internlm2-1.8b", "int8"),
    ("llama3-8b", "slot_rows")])
def test_decode_step_matches_jax(arch, layout):
    """Token-at-a-time decode through each cache layout against JAX's, and
    against the port's own forward (the JAX package's teacher-forcing
    check), at its tolerance. llama3 (rope_theta 5e5) takes one layout, to
    keep the JAX compiles few."""
    cfg, tcfg, jp, tp = _model(arch)
    B, S = 2, 9
    toks = _tokens(cfg, B, S, seed=1)
    if layout in ("paged", "int8"):
        kv = "int8" if layout == "int8" else "f32"
        jc, jt = _jax_paged(cfg, B, 16, kv)
        tc, tt = _torch_paged(tcfg, B, 16, kv)
    else:
        jc, jt = j_init_cache(cfg, B, 16), None
        tc, tt = init_cache(tcfg, B, 16), None
    step = jax.jit(lambda p, c, tok, pos, tbl: j_decode_step(
        p, cfg, c, tok, positions=pos, page_table=tbl))
    outs_j, outs_t = [], []
    for t in range(S):
        rows = layout != "slot"
        jpos = jnp.full((B,), t, jnp.int32) if rows else None
        tpos = torch.full((B,), t, dtype=torch.int32) if rows else None
        with jregistry.use("xla"):
            lj, jc = step(jp, jc, jnp.asarray(toks[:, t:t + 1]), jpos, jt)
        lt, tc = decode_step(tp, tcfg, tc, torch.from_numpy(toks[:, t:t + 1]),
                             positions=tpos, page_table=tt)
        outs_j.append(_f32(lj[:, 0]))
        outs_t.append(_t(lt[:, 0]))
    np.testing.assert_allclose(np.stack(outs_t, 1), np.stack(outs_j, 1),
                               **LOGIT_TOL)
    tf, _ = forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(np.stack(outs_t, 1), _t(tf), **LOGIT_TOL)
    assert int(tc["pos"]) == S


def test_unknown_family_raises():
    """Every family of the JAX package runs (tests/test_torch_families.py);
    a family neither package knows raises, in every entry point."""
    cfg = tconfigs.smoke_config(tconfigs.get_arch("internlm2-1.8b")).scaled(
        family="retnet")
    with pytest.raises(ValueError, match="unknown family 'retnet'"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="unknown family 'retnet'"):
        init_cache(cfg, 1, 8)
    with pytest.raises(ValueError, match="unknown family 'retnet'"):
        forward({}, cfg, {"tokens": torch.zeros(1, 2, dtype=torch.int32)})


# ----------------------------------------------------------------- mamba2 --
MAMBA = "mamba2-780m"


def test_causal_conv_and_softplus_match_jax():
    """The convolution's taps in the bf16 stream with JAX's rounding points
    (a rounded product and a rounded add per tap), its window for decode,
    and softplus as ``logaddexp(x, 0)``."""
    xbc, w, b = _np(0, (2, 9, 48)), 0.5 * _np(1, (4, 48)), 0.1 * _np(2, (48,))
    hist = _np(3, (2, 3, 48))
    for state in (None, hist):
        jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in (xbc, w, b)]
        want, wwin = j_causal_conv(
            *jargs, None if state is None else jnp.asarray(state))
        got, gwin = _causal_conv(
            *(torch.from_numpy(a).bfloat16() for a in (xbc, w, b)),
            None if state is None else torch.from_numpy(state))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_t(got), _f32(want), **BF16_TOL)
        np.testing.assert_array_equal(_t(gwin), _f32(wwin))
    v = 8 * _np(4, (1000,))
    np.testing.assert_allclose(_softplus(torch.from_numpy(v)).numpy(),
                               _f32(jax.nn.softplus(jnp.asarray(v))),
                               rtol=1e-6, atol=0)


def test_mamba2_params_carry_across_in_bf16_with_float32_decay():
    """``params_from_numpy`` walks the nested ``mamba`` dicts, counts the
    layers from any stacked leaf, and keeps ``A_log`` and ``dt_bias`` in
    float32 (JAX reads them in float32) when the rest goes to bf16."""
    cfg, tcfg, jp, tp = _model(MAMBA)
    assert param_count(tp) == j_param_count(jp)
    assert len(tp["layers"]) == cfg.n_layers
    m = tp["layers"][1]["mamba"]
    assert m["A_log"].dtype == m["dt_bias"].dtype == torch.float32
    assert m["in_proj"].dtype == m["D"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        m["dt_bias"].numpy(), _f32(jp["layers"]["mamba"]["dt_bias"][1]))
    np.testing.assert_array_equal(
        _t(tp["layers"][0]["ln"]), _f32(jp["layers"]["ln"][0]))


def test_mamba2_init_params_shapes_and_seed():
    cfg, tcfg, jp, _ = _model(MAMBA)
    a = init_params(tcfg, torch.Generator().manual_seed(0))
    b = init_params(tcfg, torch.Generator().manual_seed(0),
                    dtype=torch.bfloat16)
    assert param_count(a) == j_param_count(jp)
    for k, v in a["layers"][0]["mamba"].items():
        assert v.shape == jp["layers"]["mamba"][k].shape[1:], k
    # linspace and log in float32: the two libraries' last bits
    np.testing.assert_allclose(
        a["layers"][0]["mamba"]["A_log"].numpy(),
        _f32(jp["layers"]["mamba"]["A_log"][0]), rtol=1e-6, atol=0)
    assert b["layers"][0]["mamba"]["dt_bias"].dtype == torch.float32
    assert torch.equal(a["layers"][0]["mamba"]["dt_bias"],
                       b["layers"][0]["mamba"]["dt_bias"])
    dt = torch.nn.functional.softplus(a["layers"][0]["mamba"]["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001


@pytest.mark.parametrize("last_only", [False, True])
def test_mamba2_forward_matches_jax(last_only):
    """The forward (the scan through ``ssd``'s plain version) from the JAX
    weights carried across in bf16, the default, against JAX's forward,
    at the JAX package's logits tolerance; a length that is not a chunk
    multiple."""
    cfg, tcfg, jp, tp = _model(MAMBA)
    toks = _tokens(cfg, 2, 70)
    with jregistry.use("xla"):
        want, _ = jax.jit(lambda p, t: j_forward(
            p, cfg, {"tokens": t}, last_only=last_only))(jp, jnp.asarray(toks))
    registry.reset_dispatch_counts()
    got, aux = forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                       last_only=last_only)
    assert registry.dispatch_counts() == {("ssd", "torch"): cfg.n_layers}
    assert got.dtype == torch.bfloat16 and float(aux) == 0.0
    np.testing.assert_allclose(_t(got), _f32(want), **LOGIT_TOL)


def test_mamba2_decode_matches_jax_and_forward():
    """The JAX package's teacher-forcing check
    (tests/test_models.py::test_decode_matches_teacher_forcing) on the
    port: token-at-a-time ``decode_step`` through the recurrent cache
    against JAX's decode and against the port's own forward."""
    cfg, tcfg, jp, tp = _model(MAMBA)
    B, S = 2, 9
    toks = _tokens(cfg, B, S, seed=1)
    jc, tc = j_init_cache(cfg, B, 16), init_cache(tcfg, B, 16)
    assert {k: tuple(v.shape) for k, v in tc["layers"].items()} == \
        {k: tuple(v.shape) for k, v in jc["layers"].items()}
    step = jax.jit(lambda p, c, tok: j_decode_step(p, cfg, c, tok))
    outs_j, outs_t = [], []
    for t in range(S):
        with jregistry.use("xla"):
            lj, jc = step(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        lt, tc = decode_step(tp, tcfg, tc, torch.from_numpy(toks[:, t:t + 1]))
        outs_j.append(_f32(lj[:, 0]))
        outs_t.append(_t(lt[:, 0]))
    np.testing.assert_allclose(np.stack(outs_t, 1), np.stack(outs_j, 1),
                               **LOGIT_TOL)
    np.testing.assert_allclose(tc["layers"]["ssm"].numpy(),
                               _f32(jc["layers"]["ssm"]), atol=0.05,
                               rtol=0.05)
    tf, _ = forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(np.stack(outs_t, 1), _t(tf), **LOGIT_TOL)
    assert int(tc["pos"]) == S
    with pytest.raises(NotImplementedError, match="pageless"):
        decode_step(tp, tcfg, tc, torch.from_numpy(toks[:, :1]),
                    positions=torch.zeros(B, dtype=torch.int32),
                    page_table=torch.zeros(B, 2, dtype=torch.int32))


def teacher_forcing_gaps(n_layers: int, positions: int):
    """mamba2-780m at full width with depth cut to ``n_layers``: the
    teacher-forcing gap, max |decode - forward| over the logits of
    ``positions`` positions of 2 rows, in JAX (XLA backend) and in the
    port's plain path, on the same weights (the JAX init carried through
    numpy) and the same tokens. Returns (JAX's gap, the port's gap)."""
    cfg = jconfigs.get_arch(MAMBA).scaled(n_layers=n_layers)
    tcfg = to_torch_config_arch(cfg)
    jp = j_init_params(cfg, jax.random.PRNGKey(0))
    tp = to_torch_params(jp, cfg)
    toks = np.random.RandomState(0).randint(
        0, cfg.vocab, size=(2, positions)).astype(np.int32)
    with jregistry.use("xla"):
        jf, _ = jax.jit(lambda p, t: j_forward(p, cfg, {"tokens": t}))(
            jp, jnp.asarray(toks))
        step = jax.jit(lambda p, c, tok: j_decode_step(p, cfg, c, tok))
        jc, jd = j_init_cache(cfg, 2, positions), []
        for t in range(positions):
            lg, jc = step(jp, jc, jnp.asarray(toks[:, t:t + 1]))
            jd.append(_f32(lg[:, 0]))
    with torch.no_grad():
        tf, _ = forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
        tc, td = init_cache(tcfg, 2, positions, device="cpu"), []
        for t in range(positions):
            lg, tc = decode_step(tp, tcfg, tc,
                                 torch.from_numpy(toks[:, t:t + 1]))
            td.append(_t(lg[:, 0]))
    return (float(np.abs(np.stack(jd, 1) - _f32(jf)).max()),
            float(np.abs(np.stack(td, 1) - _t(tf)).max()))


if __name__ == "__main__":
    # The full-width teacher-forcing gap of mamba2-780m at cut depth, JAX
    # against the port, on the CPU (not a test: 512 positions of JAX's
    # decode take minutes at a few layers):
    #   PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/test_torch_models.py 8 512
    import sys
    L, S = int(sys.argv[1]), int(sys.argv[2])
    gj, gt = teacher_forcing_gaps(L, S)
    print(f"{MAMBA} full width, {L} layers, {S} positions: max |decode - "
          f"forward| JAX {gj:.4f}, port {gt:.4f}")

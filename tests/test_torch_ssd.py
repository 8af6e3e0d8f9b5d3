"""The port's SSD scan against the JAX package's, on the CPU: the plain
forward (the ``torch`` backend of ``ssd``) against ``ssd_sequential``, the
xla path and the Pallas kernel in interpret mode; the per-chunk states
against the Pallas kernel's; the plain reverse scan against the Pallas
backward kernel; ``SSDFn``'s gradients against ``jax.grad`` through the
Pallas VJP; finite gradients where exp overflows above the diagonal; the
one-token decode step; the ``cuda`` impl's refusals and its dtype rule
(B and C in float32 or in x's dtype, bf16 ones read by TMA); B and C
with bf16 values, as mamba2 hands them, against the JAX op given the same
values in float32; and the tensor-core kernels' arithmetic, float32
operands carried as bf16 terms, emulated tile by tile and held to the
limits the card holds the kernels to. Inputs come from numpy with a seed;
JAX runs its kernels in interpret mode, as its own tests run them
(tests/test_kernels.py).

  PYTHONPATH=src python -m pytest -q tests/test_torch_ssd.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import registry as jregistry
from repro.kernels.ssd import backward as j_bwd
from repro.kernels.ssd import kernel as j_kernel
from repro.kernels.ssd import ops as j_ops
from repro.kernels.ssd import ref as j_ref
from repro_torch.kernels import registry
from repro_torch.kernels.ssd import ops, ref

#: the JAX package's forward tolerance for the ssd op (tests/test_kernels.py)
ATOL = 5e-4
#: its grad tolerance for the ssd VJP, f32 and bf16 (``_GRAD_TOL["ssd"]``)
GRAD_TOL = {"float32": dict(atol=5e-3, rtol=1e-3),
            "bfloat16": dict(atol=2.0, rtol=0.1)}
#: (Bt, S, H, P, N, chunk) of tests/test_kernels.py::test_ssd_kernel_sweep
#: and a sequence shorter than the chunk
SHAPES = [(2, 128, 4, 16, 8, 32), (1, 100, 2, 8, 16, 32),
          (2, 64, 3, 16, 4, 64), (1, 37, 2, 8, 4, 64)]


def _inputs(Bt, S, H, P, N, seed=0, dtype=np.float32):
    """x, dt, A, B, C as numpy, drawn as the JAX tests draw them: dt =
    softplus(normal) / 2, A = -exp(normal / 2)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, S, H, P))
    dt = np.logaddexp(rng.standard_normal((Bt, S, H)), 0.0) * 0.5
    A = -np.exp(rng.standard_normal(H) * 0.5)
    B = rng.standard_normal((Bt, S, N))
    C = rng.standard_normal((Bt, S, N))
    return [a.astype(dtype) for a in (x, dt, A, B, C)]


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
            for a in arrays]


def _j(arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", SHAPES)
def test_plain_ssd_matches_jax(Bt, S, H, P, N, chunk):
    arrays = _inputs(Bt, S, H, P, N)
    y0, h0 = j_ref.ssd_sequential(*_j(arrays))
    with jregistry.use("xla"):
        y1, h1 = j_ops.ssd(*_j(arrays), chunk=chunk)
    with jregistry.use("pallas"):
        y2, h2 = j_ops.ssd(*_j(arrays), chunk=chunk)
    with registry.use("torch"):
        y, h = registry.dispatch("ssd", *_t(arrays), chunk=chunk)
    assert y.dtype == torch.float32 and h.shape == (Bt, H, P, N)
    for want_y, want_h in ((y0, h0), (y1, h1), (y2, h2)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=ATOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL)
    ys, hs = ref.ssd_sequential(*_t(arrays))
    np.testing.assert_allclose(ys.numpy(), np.asarray(y0), atol=ATOL)
    np.testing.assert_allclose(hs.numpy(), np.asarray(h0), atol=ATOL)


def _pallas_operands(arrays, chunk):
    """The JAX wrapper's kernel operands (padded (Bt, H, S, ·) float32)."""
    return j_ops._kernel_operands(*_j(arrays), chunk)


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", SHAPES)
def test_states_match_the_pallas_kernel(Bt, S, H, P, N, chunk):
    """The state entering each chunk, against the Pallas kernel's
    ``return_states`` output (Bt*H, nc, P, N)."""
    arrays = _inputs(Bt, S, H, P, N, seed=1)
    _, _, hins = j_kernel.ssd(*_pallas_operands(arrays, chunk), chunk=chunk,
                              interpret=True, return_states=True)
    y, h, states = ref.ssd_chunked(*_t(arrays), chunk=chunk,
                                   return_states=True)
    nc = -(-S // chunk)
    assert states.shape == (Bt, H, nc, P, N)
    np.testing.assert_allclose(states.reshape(Bt * H, nc, P, N).numpy(),
                               np.asarray(hins), atol=ATOL)
    np.testing.assert_allclose(states[:, :, 0].numpy(), 0.0)


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", SHAPES)
def test_plain_ssd_bwd_matches_the_pallas_kernel(Bt, S, H, P, N, chunk):
    """The plain reverse scan against ``backward.ssd_bwd`` in interpret
    mode on the same operands, states and cotangents: dxdt, da, and dB
    and dC per head, at the forward's tolerance scaled to the outputs'
    size."""
    arrays = _inputs(Bt, S, H, P, N, seed=2)
    rng = np.random.default_rng(3)
    dy = rng.standard_normal((Bt, S, H, P)).astype(np.float32)
    dh = rng.standard_normal((Bt, H, P, N)).astype(np.float32)
    xdt, a, Bm, Cm = _pallas_operands(arrays, chunk)
    _, _, hins = j_kernel.ssd(xdt, a, Bm, Cm, chunk=chunk, interpret=True,
                              return_states=True)
    pad = xdt.shape[2] - S
    dy_k = jnp.pad(jnp.asarray(dy).transpose(0, 2, 1, 3),
                   ((0, 0), (0, 0), (0, pad), (0, 0)))
    want = j_bwd.ssd_bwd(xdt, a, Bm, Cm, dy_k, hins,
                         jnp.asarray(dh).reshape(Bt * H, P, N), chunk=chunk,
                         interpret=True)
    _, _, states = ref.ssd_chunked(*_t(arrays), chunk=chunk,
                                   return_states=True)
    got = ref.ssd_bwd(*_t(arrays), torch.from_numpy(dy), states,
                      torch.from_numpy(dh), chunk=chunk)
    for name, g, w in zip(("dxdt", "da", "dB", "dC"), got, want):
        w = np.asarray(w).transpose(0, 2, 1, 3)[:, :S]       # model layout
        if name == "da":
            w = w[..., 0]
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL * scale,
                                   err_msg=name)


def _jax_grads(arrays, chunk, jdtype):
    """jax.grad of sum(y^2) + sum(h^2) through the Pallas VJP, as
    tests/test_kernels.py::test_registry_grad_parity takes it."""
    def loss(*args):
        y, h = j_ops.ssd(*args, chunk=chunk)
        return (y.astype(jnp.float32) ** 2).sum() + (h ** 2).sum()
    with jregistry.use("pallas"):
        return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*_j(arrays, jdtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bt,S,H,P,N,chunk", [(1, 37, 2, 8, 4, 64),
                                              (2, 64, 3, 16, 4, 64),
                                              (1, 100, 2, 8, 16, 32)])
def test_ssdfn_grads_match_the_pallas_vjp(Bt, S, H, P, N, chunk, dtype):
    """``SSDFn`` on the plain backend (the forward, the states sweep and
    the plain reverse scan, chained to dx, ddt, dA, dB, dC) against
    ``jax.grad`` through the Pallas custom VJP, every input in ``dtype``
    as the JAX test makes them, at the JAX package's grad tolerance."""
    arrays = _inputs(Bt, S, H, P, N, seed=4)
    want = _jax_grads(arrays, chunk, getattr(jnp, dtype))
    args = [t.requires_grad_() for t in _t(arrays, getattr(torch, dtype))]
    registry.reset_dispatch_counts()
    with registry.use("torch"):
        y, h = ops.ssd(*args, chunk=chunk)
        loss = (y.float() ** 2).sum() + (h ** 2).sum()
        got = torch.autograd.grad(loss, args)
    assert registry.dispatch_counts() == {("ssd", "torch"): 2,
                                          ("ssd_bwd", "torch"): 1}
    for name, a, g, w in zip("x dt A B C".split(), args, got, want):
        assert g.dtype == a.dtype, name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   **GRAD_TOL[dtype], err_msg=f"d{name}")


def test_grads_finite_where_the_decay_overflows():
    """A = -16 (mamba2-780m's last head) and dt of 2 make cs_t - cs_s pass
    88 above the diagonal within a chunk, where exp overflows to inf. The
    plain forward's autograd and ``SSDFn`` both take exp of the select
    only, so the gradients stay finite, and they agree: both sum in
    float64 and round to float32 at the end (1.3e-6 relative at most)."""
    Bt, S, H, P, N = 1, 64, 2, 8, 4
    arrays = _inputs(Bt, S, H, P, N, seed=5)
    arrays[1] = np.full((Bt, S, H), 2.0, np.float32)       # dt
    arrays[2] = np.array([-16.0, -1.0], np.float32)        # A
    cs = np.cumsum(arrays[1][0, :, 0] * arrays[2][0])
    assert (cs[0] - cs[-1]) > 88.0          # exp(cs_s - cs_t) is inf in f32
    grads = {}
    for how in ("function", "autograd"):
        args = [t.requires_grad_() for t in _t(arrays)]
        with registry.use("torch"):
            y, h = (ops.ssd(*args) if how == "function" else
                    ref.ssd_chunked(*args))
            loss = (y ** 2).sum() + (h ** 2).sum()
            grads[how] = torch.autograd.grad(loss, args)
        assert all(torch.isfinite(g).all() for g in grads[how]), how
    for g, w in zip(grads["function"], grads["autograd"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-3)


def test_decode_step_matches_sequential():
    """tests/test_kernels.py::test_ssd_decode_trajectory: the recurrence one
    token at a time against JAX's ``ssd_sequential``."""
    Bt, S, H, P, N = 2, 24, 4, 16, 8
    arrays = _inputs(Bt, S, H, P, N, seed=6)
    arrays[1] = arrays[1] * 2.0                          # dt = softplus
    y_seq, h_seq = j_ref.ssd_sequential(*_j(arrays))
    x, dt, A, B, C = _t(arrays)
    h = torch.zeros(Bt, H, P, N)
    for t in range(S):
        y_t, h = ops.ssd_decode_step(x[:, t], dt[:, t], A, B[:, t], C[:, t],
                                     h)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_seq), atol=1e-4)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_seq[:, -1]),
                               atol=1e-4)


def test_initial_state_runs_on_the_plain_version():
    """An initial state h0: the plain chunked form against JAX's
    ``ssd_sequential(h0=...)``; :func:`ops.ssd` takes the plain path
    (also under grad), and the ``cuda`` impl refuses it by name."""
    Bt, S, H, P, N = 2, 50, 2, 8, 4
    arrays = _inputs(Bt, S, H, P, N, seed=7)
    h0 = np.random.default_rng(8).standard_normal(
        (Bt, H, P, N)).astype(np.float32)
    want_y, want_h = j_ref.ssd_sequential(*_j(arrays), h0=jnp.asarray(h0))
    args = [t.requires_grad_() for t in _t(arrays)]
    y, h = ops.ssd(*args, chunk=32, h0=torch.from_numpy(h0))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               atol=ATOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h),
                               atol=ATOL)
    assert y.grad_fn is not None and "SSDFn" not in type(y.grad_fn).__name__
    why = ops._rejects(*args, chunk=32, h0=torch.zeros(1))
    assert "CUDA tensors" in why
    with pytest.raises(ValueError, match="zero state"):
        ops.ssd_cuda(*args, h0=torch.zeros(1))


def test_cuda_impl_refuses_what_it_cannot_run():
    arrays = _t(_inputs(1, 8, 2, 64, 128))
    with registry.use("cuda"):
        with pytest.raises(RuntimeError, match="cannot run"):
            registry.select("ssd", *arrays, chunk=64)
        with pytest.raises(RuntimeError, match="cannot run"):
            registry.select("ssd_bwd", *arrays, arrays[0], None, chunk=64)
    # per-call capability, as it reads on a card: the built shapes only
    assert (64, 64, 128) in ops.SHAPES and (128, 64, 128) not in ops.SHAPES
    with pytest.raises(ValueError, match="CUDA device"):
        ops.ssd_cuda(*arrays)
    assert registry.resolved_backend(arrays[0].device) == "torch"


def _bf16_values(a):
    """numpy float32 values that bf16 represents exactly."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def test_bf16_b_c_match_jax_given_the_same_values():
    """mamba2 hands the scan the conv's bf16 B and C as they are; the JAX
    model upcasts the same values itself. The plain forward with bf16 B, C
    against the JAX op (xla path and interpret-mode Pallas) given them in
    float32, and ``SSDFn``'s grads against ``jax.grad`` through the Pallas
    VJP with B and C cast from bf16 inside (so dB and dC come back rounded
    to bf16, as ``SSDFn`` returns them in B's dtype)."""
    Bt, S, H, P, N, chunk = 2, 100, 3, 16, 8, 32
    arrays = _inputs(Bt, S, H, P, N, seed=9)
    arrays[3], arrays[4] = _bf16_values(arrays[3]), _bf16_values(arrays[4])
    x, dt, A, B, C = _t(arrays)
    B16, C16 = B.bfloat16(), C.bfloat16()
    with registry.use("torch"):
        y, h = registry.dispatch("ssd", x, dt, A, B16, C16, chunk=chunk)
    for backend in ("xla", "pallas"):
        with jregistry.use(backend):
            wy, wh = j_ops.ssd(*_j(arrays), chunk=chunk)
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=ATOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), atol=ATOL)

    def loss(x, dt, A, B, C):
        y, h = j_ops.ssd(x, dt, A, B.astype(jnp.float32),
                         C.astype(jnp.float32), chunk=chunk)
        return (y ** 2).sum() + (h ** 2).sum()
    jargs = _j(arrays[:3]) + _j(arrays[3:], jnp.bfloat16)
    with jregistry.use("pallas"):
        want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*jargs)
    args = [t.requires_grad_() for t in (x, dt, A, B16, C16)]
    with registry.use("torch"):
        y, h = ops.ssd(*args, chunk=chunk)
        got = torch.autograd.grad((y ** 2).sum() + (h ** 2).sum(), args)
    for name, a, g, w in zip("x dt A B C".split(), args, got, want):
        assert g.dtype == a.dtype, name
        tol = (dict(rtol=1e-2, atol=1e-2) if a.dtype == torch.bfloat16
               else GRAD_TOL["float32"])
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol,
                                   err_msg=f"d{name}")


def test_wrappers_take_b_c_in_float32_or_x_dtype_and_align_tma_operands():
    """The ``cuda`` impls' operand rule, read before any device check: B
    and C in float32 or in x's dtype, one dtype for both; bf16 x, B and C
    choose the tensor-core bodies, whose TMA operands need 16-byte aligned
    rows; anything else the CUDA-core bodies."""
    Bt, S, H, P, N = 1, 8, 2, 64, 128
    x, dt, A, B, C = _t(_inputs(Bt, S, H, P, N))
    with pytest.raises(ValueError, match="float32"):
        ops.ssd_cuda(x, dt, A, B.bfloat16(), C.bfloat16())
    with pytest.raises(ValueError, match="share a dtype"):
        ops.ssd_cuda(x.bfloat16(), dt, A, B.bfloat16(), C)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.ssd_cuda(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16())
    assert ops._body(x, B, C, "ssd") == ops._TYPE[torch.float32]
    assert ops._body(x.bfloat16(), B, C, "ssd") == ops._TYPE[torch.bfloat16]
    x16, B16, C16 = x.bfloat16(), B.bfloat16(), C.bfloat16()
    assert ops._body(x16, B16, C16, "ssd") == ops._TC
    # x as the model hands it, a view of a wider projection: aligned
    wide = torch.zeros(Bt, S, H * P + 2 * N, dtype=torch.bfloat16)
    view = wide[..., :H * P].reshape(Bt, S, H, P)
    assert ops._body(view, B16, C16, "ssd", x16) == ops._TC
    odd = torch.zeros(Bt, S, H * P + 3, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops._body(odd[..., :H * P].reshape(Bt, S, H, P), B16, C16, "ssd")
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops._body(x16, B16, C16, "ssd_bwd", odd[..., 1:H * P + 1]
                  .reshape(Bt, S, H, P))


# ---------------------------------------------------- the kernels' arithmetic
#: bf16 terms of each float32 operand in the tensor-core kernels
#: (csrc/ssd.cu, notes 3 and 4): two for the forward's M' = (C B^T o decay)
#: dt_s and state h (y is bf16) and for the backward's dh, h_in and e dy;
#: three for U = x dt w (into h), G^T = (C B^T o decay)^T and DD = dy x^T o
#: decay o dt_s, where two terms read above half the 1e-5 limit
#: (``term_sweep(2, 1024, 12)``: the states, dxdt and dC at 5.3-5.8e-6)
KERNEL_TERMS = dict(M=2, h=2, U=3, G=3, DD=3, dh=2, hin=2, eY=2)
ONE_TERM = {k: 1 for k in KERNEL_TERMS}
#: share of y's bf16 outputs that may differ from the plain version's
#: (chip_smoke.py and tests/test_torch_cuda.py hold the kernel to it)
P_FLIP_LIMIT = 0.02


def _terms(v: torch.Tensor, k: int) -> torch.Tensor:
    """v carried as k bf16 terms: hi = bf16(v), then bf16 of each rest."""
    out, rest = torch.zeros_like(v), v
    for _ in range(k):
        t = rest.bfloat16().float()
        out, rest = out + t, rest - t
    return out


def _ssd_in_terms(x, dt, A, B, C, dy, dh_final, L, terms,
                  cs_dtype=torch.float64):
    """Both tensor-core kernels' arithmetic in float32 torch, chunk by
    chunk, each float32 operand of a product carried as ``terms[name]``
    bf16 terms (products of two bf16 operands exact, sums float32): cs in
    ``cs_dtype`` (the kernels': float64), the decay exp of its differences
    rounded to float32. Returns y (float32, before the kernel's bf16
    rounding), h_final, the states, dxdt, da, dB and dC."""
    f32, f64 = torch.float32, torch.float64
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    nc = -(-S // L)
    pad = nc * L - S

    def chunks(t, heads):     # (Bt, S[, H], w) -> (Bt, heads, nc, L, w)
        t = torch.nn.functional.pad(t.to(f32),
                                    (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(Bt, nc, L, heads, t.shape[-1]).permute(0, 3, 1, 2, 4)
    xs, dys = chunks(x, H), chunks(dy, H)
    Bs, Cs = chunks(B, 1), chunks(C, 1)
    dts = torch.nn.functional.pad(dt.to(f32), (0, 0, 0, pad)).reshape(
        Bt, nc, L, H).permute(0, 3, 1, 2)
    cs = torch.cumsum(dts.to(cs_dtype) * A.to(cs_dtype)[None, :, None, None],
                      -1)
    tri = torch.ones(L, L, dtype=torch.bool).tril()
    ninf = torch.tensor(-torch.inf)

    def parts(c):
        csc = cs[:, :, c]
        csL = csc[..., -1:]
        e, w = torch.exp(csc).to(f32), torch.exp(csL - csc).to(f32)
        lmat = (csc[..., :, None] - csc[..., None, :]).to(f32)
        dec = torch.exp(torch.where(tri, lmat, ninf))
        return csL, e, w, dec, dts[:, :, c]

    h = torch.zeros(Bt, H, P, N)
    ys, states = [], []
    for c in range(nc):
        X, Bm, Cm = xs[:, :, c], Bs[:, :, c], Cs[:, :, c]
        csL, e, w, dec, d = parts(c)
        M = (Cm @ Bm.transpose(-1, -2)) * dec * d[..., None, :]
        states.append(h)
        yT = (_terms(h, terms["h"]) @ Cm.transpose(-1, -2)) * e[..., None, :]
        ys.append(yT.transpose(-1, -2) + _terms(M, terms["M"]) @ X)
        U = X * (w * d)[..., None]
        h = torch.exp(csL).to(f32)[..., None] * h + \
            _terms(U, terms["U"]).transpose(-1, -2) @ Bm
    st = torch.stack(states, 2)
    dh, outs = dh_final.to(f32).clone(), []
    for c in reversed(range(nc)):
        X, Y, Bm, Cm = xs[:, :, c], dys[:, :, c], Bs[:, :, c], Cs[:, :, c]
        csL, e, w, dec, d = parts(c)
        hin, wd = st[:, :, c], (w * d)[..., None]
        hd = (hin * dh).sum((-1, -2))
        sT = Bm @ Cm.transpose(-1, -2)                      # (s, t)
        ddT = (X @ Y.transpose(-1, -2)) * dec.transpose(-1, -2) * d[..., None]
        ET = ddT * sT
        dhs, hins = _terms(dh, terms["dh"]), _terms(hin, terms["hin"])
        xdh = X @ dhs
        dw = wd[..., 0] * (Bm * xdh).sum(-1)
        dB = xdh * wd + _terms(ddT, terms["DD"]) @ Cm
        gT = sT * dec.transpose(-1, -2)
        dxdt = w[..., None] * (Bm @ dhs.transpose(-1, -2)) + \
            _terms(gT, terms["G"]) @ Y
        DD = (Y @ X.transpose(-1, -2)) * dec * d[..., None, :]
        dyh = Y @ hins
        de = e * (Cm * dyh).sum(-1)
        dC = dyh * e[..., None] + _terms(DD, terms["DD"]) @ Bm
        dh = torch.exp(csL).to(f32)[..., None] * dh + _terms(
            (e[..., None] * Y).transpose(-1, -2), terms["eY"]) @ Cm
        dcs = ET.sum(-2) - ET.sum(-1) + de - dw
        dcs[..., -1] += dw.sum(-1) + torch.exp(csL[..., 0]).to(f32) * hd
        da = torch.flip(torch.cumsum(torch.flip(dcs, [-1]), -1), [-1])
        outs.append((dxdt, da[..., None], dB, dC))
    outs.reverse()

    def model(t):            # (Bt, H, nc, L, w) -> (Bt, S, H, w)
        return t.permute(0, 2, 3, 1, 4).reshape(Bt, nc * L, H, -1)[:, :S]
    dxdt, da, dB, dC = (model(torch.stack(t, 2)) for t in zip(*outs))
    return (model(torch.stack(ys, 2)), h, st, dxdt, da[..., 0], dB, dC)


def _normwise(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _model_case(Bt, S, H, P, N, decay, seed):
    """bf16 x, B, C and dy (as mamba2 hands them), float32 dt, A and
    dh_final; ``decay="model"`` is mamba2's A = -(1..16) with dt up to ~2,
    "test" the JAX tests' draws."""
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
    dt = np.logaddexp(rng.standard_normal((Bt, S, H)), 0.0)
    if decay == "model":
        A = -np.linspace(1.0, 16.0, H)
    else:
        dt, A = dt * 0.5, -np.exp(rng.standard_normal(H) * 0.5)
    x = t(rng.standard_normal((Bt, S, H, P)), bf)
    B, C = (t(rng.standard_normal((Bt, S, N)), bf) for _ in range(2))
    dy = t(rng.standard_normal((Bt, S, H, P)), bf)
    dh = t(rng.standard_normal((Bt, H, P, N)))
    return (x, t(dt), t(A), B, C), dy, dh


@pytest.mark.parametrize("decay", ["test", "model"])
def test_bf16_terms_meet_the_limits(decay):
    """The tensor-core kernels' arithmetic at mamba2's head (L=64, P=64,
    N=128), emulated tile by tile with ``KERNEL_TERMS``, against the
    float64 plain versions: every float32 output within half its limit
    (1e-5; da 1e-4), and y's bf16 outputs off the plain version's at most
    ``P_FLIP_LIMIT``. With every float32 operand rounded once to bf16 the
    float32 outputs fail their limit and y's flip share passes
    ``P_FLIP_LIMIT``, as does ``ref.ssd_chunked_rounded``, the card's
    yardstick; the normwise 8e-3 on y cannot see that loss."""
    L = 64
    args, dy, dh = _model_case(1, 256, 4, 64, 128, decay, seed=10)
    wy, wh, ws = ref.ssd_chunked(*args, chunk=L, return_states=True)
    want = (wh, ws, *ref.ssd_bwd(*args, dy, ws, dh, chunk=L))
    limits = (1e-5, 1e-5, 1e-5, 1e-4, 1e-5, 1e-5)

    def flips(y):
        return float((y.bfloat16() != wy).float().mean())
    got = _ssd_in_terms(*args, dy, dh, L, KERNEL_TERMS)
    errs = [_normwise(g, w) for g, w in zip(got[1:], want)]
    assert all(e <= lim / 2 for e, lim in zip(errs, limits)), errs
    assert flips(got[0]) <= P_FLIP_LIMIT
    once = _ssd_in_terms(*args, dy, dh, L, ONE_TERM)
    errs = [_normwise(g, w) for g, w in zip(once[1:], want)]
    assert max(e / lim for e, lim in zip(errs, limits)) > 1, errs
    assert flips(once[0]) > P_FLIP_LIMIT
    assert _normwise(once[0], wy) <= 8e-3
    assert flips(ref.ssd_chunked_rounded(*args, chunk=L)) > P_FLIP_LIMIT


def term_sweep(Bt=1, S=256, H=4):
    """The emulated kernels' errors against the float64 plain versions at
    mamba2's head (L=64, P=64, N=128), by decay: normwise for h_final, the
    states, dxdt, da, dB and dC, and y's bf16 flip share; for
    ``KERNEL_TERMS``, every operand at one term, each operand at two terms
    with the rest as chosen, and cs summed in float32. Not a test: it
    prints the numbers the choice of terms rests on."""
    L, rows = 64, []
    for decay in ("test", "model"):
        args, dy, dh = _model_case(Bt, S, H, 64, 128, decay, seed=10)
        wy, wh, ws = ref.ssd_chunked(*args, chunk=L, return_states=True)
        want = (wh, ws, *ref.ssd_bwd(*args, dy, ws, dh, chunk=L))
        runs = [("kernel", KERNEL_TERMS, torch.float64),
                ("one term", ONE_TERM, torch.float64),
                ("cs in float32", KERNEL_TERMS, torch.float32)]
        runs += [(f"{k} at two", {**KERNEL_TERMS, k: 2}, torch.float64)
                 for k, v in KERNEL_TERMS.items() if v == 3]
        for name, terms, cs_dtype in runs:
            got = _ssd_in_terms(*args, dy, dh, L, terms, cs_dtype)
            errs = [_normwise(g, w) for g, w in zip(got[1:], want)]
            flips = float((got[0].bfloat16() != wy).float().mean())
            rows.append((decay, name, errs, flips))
            print(f"{decay:5s} {name:14s} " + " ".join(
                f"{n}={e:.2e}" for n, e in zip(
                    ("h", "states", "dxdt", "da", "dB", "dC"), errs))
                + f" y_flips={100 * flips:.3f}%", flush=True)
        once = ref.ssd_chunked_rounded(*args, chunk=L)
        print(f"{decay:5s} ssd_chunked_rounded y_flips="
              f"{100 * float((once != wy).float().mean()):.3f}%")
    return rows


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_ssd.py [Bt S H]
    import sys
    term_sweep(*(int(a) for a in sys.argv[1:4]))

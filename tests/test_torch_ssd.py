"""The port's SSD scan against the JAX package's, on the CPU: the plain
forward (the ``torch`` backend of ``ssd``) against ``ssd_sequential``, the
xla path and the Pallas kernel in interpret mode; the per-chunk states
against the Pallas kernel's; the plain reverse scan against the Pallas
backward kernel; ``SSDFn``'s gradients against ``jax.grad`` through the
Pallas VJP; finite gradients where exp overflows above the diagonal; the
one-token decode step; and the ``cuda`` impl's refusals. Inputs come from
numpy with a seed; JAX runs its kernels in interpret mode, as its own
tests run them (tests/test_kernels.py).

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

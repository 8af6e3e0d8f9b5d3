"""The port's kernels against the JAX package's: each plain PyTorch version
(the path CPU tensors take) against the Pallas kernel in interpret mode and
against the JAX ref, on the same numpy inputs; and the CUDA wrappers' checks
and chunking. The CUDA kernels themselves are held against their plain
versions on the card by tests/test_torch_cuda.py."""
import ctypes
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gram as jgram_core
from repro.core import update_rules as jur
from repro.kernels.gram import ops as jgram_ops, ref as jgram_ref
from repro.kernels.prox_step import ops as jprox_ops, ref as jprox_ref
from repro.kernels import registry as jregistry
from repro.kernels.flash_attention import ops as jfa_ops, ref as jfa_ref
from repro.models.attention import attention as j_attention
from repro_torch.core import update_rules as ur
from repro_torch.core.gram import augment, augment_rows
from repro_torch.core.sampling import gather_columns
from repro_torch.kernels import launch_counts, registry, reset_launch_counts
from repro_torch.kernels.gram import ops as gram_ops, ref as gram_ref
from repro_torch.kernels.prox_step import ops as prox_ops, ref as prox_ref
from repro_torch.kernels.prox_step.ops import prox_scalars
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref

VARIANTS = ("l1", "elastic_net", "box", "none")
#: [t, lam, mu, lo, hi]: every variant's scalars non-trivial
SCAL = (0.05, 0.02, 0.3, -0.1, 0.2)


def _gram_tol(m):
    # the JAX package's own gram tolerance (tests/test_kernels.py): float32
    # sums of m products taken in another order
    return dict(rtol=1e-5, atol=m * 1e-6)


def _xs(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _prox_inputs(d, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((d, d)).astype(np.float32)
    G = (A @ A.T / d).astype(np.float32)
    R = rng.standard_normal(d).astype(np.float32)
    v = rng.standard_normal(d).astype(np.float32)
    return G, R, v


# ------------------------------------------------------------------ gram ---
@pytest.mark.parametrize("d", [8, 18, 54, 61])
@pytest.mark.parametrize("m", [1, 129, 2048])
def test_gram_ref_matches_pallas_and_jax_ref(d, m):
    Xs = _xs((d, m), seed=d * 7919 + m)
    got = gram_ref.gram(torch.from_numpy(Xs)).numpy()
    pallas = np.asarray(jgram_ops.gram(jnp.asarray(Xs), interpret=True))
    jref = np.asarray(jgram_ref.gram(jnp.asarray(Xs)))
    np.testing.assert_allclose(got, pallas, **_gram_tol(m))
    np.testing.assert_allclose(got, jref, **_gram_tol(m))


def test_gram_ref_batched_matches_pallas_per_draw():
    k, d, m = 3, 18, 129
    Xs = _xs((k, d, m), seed=3)
    got = gram_ref.gram(torch.from_numpy(Xs)).numpy()
    assert got.shape == (k, d, d)
    for j in range(k):
        pallas = np.asarray(jgram_ops.gram(jnp.asarray(Xs[j]),
                                           interpret=True))
        np.testing.assert_allclose(got[j], pallas, **_gram_tol(m))


@pytest.mark.parametrize("m", [1, 31, 32, 129, 2048, 5810, 58_101,
                               500_000, 5_000_000])
def test_gram_chunking_depends_on_m_alone_and_covers_m(m):
    chunk, nchunks = gram_ops.chunking(m)
    assert chunk % 32 == 0 and 1 <= nchunks <= 128
    assert (nchunks - 1) * chunk < m <= nchunks * chunk


def test_gram_cuda_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA device"):
        gram_ops.gram_cuda(torch.zeros(2, 4, 8))


# ----------------------------------------------------------- gram_gather ---
def _lasso_arrays(d, n, m, k, seed):
    """X (d, n), y (n,) and k draws (k, m) of [0, n) with replacement, each
    with its first index drawn again last."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((d, n)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    idx = rng.integers(0, n, (k, m))
    idx[:, -1] = idx[:, 0]
    return X, y, idx


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("k,d,m", [(1, 54, 581), (4, 18, 5000), (3, 60, 129)])
def test_gram_gather_ref_matches_jax_gram_blocks(k, d, m, backend):
    """The plain gram_gather over the sample-major rows against the JAX
    package's gram_blocks (take, then the gram op, R = Xs ys) on the same
    arrays, through XLA and through the Pallas kernel in interpret mode.
    n < m, so draws repeat rows besides the forced duplicate."""
    n = 2 * m // 3
    X, y, idx = _lasso_arrays(d, n, m, k, seed=k * 1009 + d + m)
    G, R = gram_ref.gram_gather(
        augment_rows(torch.from_numpy(X), torch.from_numpy(y)),
        torch.from_numpy(idx), d + 1, 1.0 / m)
    with jregistry.use(backend):
        jG, jR = jgram_core.gram_blocks(jnp.asarray(X), jnp.asarray(y),
                                        jnp.asarray(idx.astype(np.int32)))
    # _gram_tol(m) on the sums, which are scaled by 1/m here
    tol = dict(rtol=1e-5, atol=1e-6)
    assert G.shape == (k, d, d) and R.shape == (k, d)
    np.testing.assert_allclose(G.numpy(), np.asarray(jG), **tol)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), **tol)


def test_gram_gather_ref_is_gram_of_the_gathered_columns():
    d, n, m, k = 21, 300, 257, 3
    X, y, idx = _lasso_arrays(d, n, m, k, seed=5)
    X, y, idx = torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(idx)
    G, R = gram_ref.gram_gather(augment_rows(X, y), idx, d + 1, 1.0 / m)
    Ga = gram_ref.gram(gather_columns(augment(X, y), idx)) * (1.0 / m)
    np.testing.assert_allclose(G.numpy(), Ga[:, :d, :d].numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(R.numpy(), Ga[:, :d, d].numpy(), rtol=1e-6,
                               atol=1e-7)


def test_gram_gather_ref_counts_a_row_drawn_twice_twice():
    X = torch.arange(12, dtype=torch.float32).reshape(2, 6) - 5.0
    y = torch.linspace(-1.0, 1.0, 6)
    G, R = gram_ref.gram_gather(augment_rows(X, y),
                                torch.tensor([[2, 4, 2]]), 3, 1.0 / 3)
    x2, x4 = X[:, 2].double(), X[:, 4].double()
    want_G = (2 * torch.outer(x2, x2) + torch.outer(x4, x4)) / 3
    want_R = (2 * x2 * y[2] + x4 * y[4]) / 3
    np.testing.assert_allclose(G[0].numpy(), want_G.numpy(), rtol=1e-6)
    np.testing.assert_allclose(R[0].numpy(), want_R.numpy(), rtol=1e-6)


def test_gram_gather_cuda_wrapper_refuses_bad_operands():
    rows, idx = torch.zeros(10, 8), torch.zeros(2, 5, dtype=torch.int64)
    call = gram_ops.gram_gather_cuda
    with pytest.raises(ValueError, match="one CUDA device"):
        call(rows, idx, 5, 0.2)
    with pytest.raises(ValueError, match="Xy_rows must be torch.float32"):
        call(rows.double(), idx, 5, 0.2)
    with pytest.raises(ValueError, match="idx must be torch.int64"):
        call(rows, idx.int(), 5, 0.2)
    with pytest.raises(ValueError, match="idx must be contiguous"):
        call(rows, torch.zeros(5, 2, dtype=torch.int64).T, 5, 0.2)
    with pytest.raises(ValueError, match="r <= r_pad = 8, got r=9"):
        call(rows, idx, 9, 0.2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        call(torch.zeros(10, 6), idx, 5, 0.2)
    with pytest.raises(RuntimeError, match="backend 'cuda' cannot run"):
        with registry.use("cuda"):
            registry.dispatch("gram_gather", rows, idx, 5, 0.2)


# ------------------------------------------------------------- prox ops ----
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("d", [18, 54])
def test_prox_step_ref_matches_pallas_and_jax_ref(variant, d):
    G, R, v = _prox_inputs(d, seed=d)
    got = prox_ref.prox_step(torch.from_numpy(G), torch.from_numpy(R),
                             torch.from_numpy(v), prox_scalars(*SCAL),
                             variant=variant).numpy()
    t, lam, mu, lo, hi = SCAL
    args = (jnp.asarray(G), jnp.asarray(R), jnp.asarray(v), t, lam, mu, lo,
            hi)
    pallas = jprox_ops.prox_step(*args, variant=variant, interpret=True)
    jref = jprox_ref.prox_step(*args, variant=variant)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("d,Q", [(18, 5), (54, 3)])
def test_prox_loop_ref_matches_pallas_and_jax_ref(variant, d, Q):
    G, R, v = _prox_inputs(d, seed=d + Q)
    got = prox_ref.prox_loop(torch.from_numpy(G), torch.from_numpy(R),
                             torch.from_numpy(v), prox_scalars(*SCAL), Q=Q,
                             variant=variant).numpy()
    t, lam, mu, lo, hi = SCAL
    G_, R_, v_ = jnp.asarray(G), jnp.asarray(R), jnp.asarray(v)
    pallas = jprox_ops.prox_loop(G_, R_, v_, t, lam, Q, mu, lo, hi,
                                 variant=variant, interpret=True)
    jref = jprox_ref.prox_loop(G_, R_, v_, t, lam, Q, mu, lo, hi,
                               variant=variant)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jref), rtol=1e-5, atol=1e-5)


def test_prox_ops_reject_unknown_variant_and_bad_operands():
    G, R, v = (torch.from_numpy(a) for a in _prox_inputs(4))
    with pytest.raises(ValueError, match="unknown prox variant"):
        prox_ref.prox_step(G, R, v, prox_scalars(*SCAL), variant="l2")
    with pytest.raises(ValueError, match="unknown prox variant"):
        prox_ops.prox_step_cuda(G, R, v, prox_scalars(*SCAL), variant="l2")
    with pytest.raises(ValueError, match="CUDA device"):
        prox_ops.prox_loop_cuda(G, R, v, prox_scalars(*SCAL), Q=2)


# ------------------------------------------------------- prox block ops ---
#: (k, d) of the block ops' CPU cases: covtype's d = 54, susy's d = 18 and a
#: ragged d = 61, at k = 1 (the classical schedule), 7 and 32 (the CA block)
BLOCK_SHAPES = [(k, d) for k in (1, 7, 32) for d in (18, 54, 61)]
BLOCK_Q = 5


def _block_inputs(k, d, seed):
    """k Gram blocks G_i = A_i A_i^T / d, R (k, d), and w_prev, w (d,)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((k, d, d)).astype(np.float32)
    G = (A @ A.transpose(0, 2, 1) / d).astype(np.float32)
    R = rng.standard_normal((k, d)).astype(np.float32)
    w_prev, w = rng.standard_normal((2, d)).astype(np.float32)
    return G, R, w_prev, w


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("k,d", BLOCK_SHAPES)
@pytest.mark.parametrize("rule", ["fista", "pnm"])
def test_block_ref_is_bitwise_k_stepwise_updates(rule, k, d, variant):
    """The plain block ops, and the block rules over them, give the bits of
    k calls of the stepwise rules (the solvers' route before the block
    kernels): W row for row, and the state they leave."""
    G, R, wp, w = (torch.from_numpy(a) for a in _block_inputs(k, d, k + d))
    scal = prox_scalars(*SCAL)
    state = ur.IterState(w_prev=wp, w=w, j=k)   # j0 = 1 meets mom = 0
    step, rows = state, []
    for i in range(k):
        step = (ur.fista_update(G[i], R[i], step, scal, variant=variant)
                if rule == "fista" else
                ur.pnm_update(G[i], R[i], step, scal, BLOCK_Q,
                              variant=variant))
        rows.append(step.w)
    if rule == "fista":
        W = prox_ref.prox_step_block(G, R, wp, w, scal, j0=k,
                                     variant=variant)
        new, W_rule = ur.fista_block(G, R, state, scal, variant=variant)
    else:
        W = prox_ref.prox_loop_block(G, R, w, scal, Q=BLOCK_Q,
                                     variant=variant)
        new, W_rule = ur.pnm_block(G, R, state, scal, BLOCK_Q,
                                   variant=variant)
    assert W.shape == (k, d)
    assert torch.equal(W, torch.stack(rows)) and torch.equal(W_rule, W)
    assert torch.equal(new.w, step.w) and torch.equal(new.w_prev, step.w_prev)
    assert new.j == step.j == k + k


@functools.lru_cache(maxsize=None)
def _jax_update(rule, variant):
    """The JAX package's update rule, jitted (as its s-step core runs it)
    with the prox scalars bound; traced under the XLA backend."""
    t, lam, mu, lo, hi = SCAL
    if rule == "fista":
        return jax.jit(lambda G, R, st: jur.fista_update(
            G, R, st, t, lam, mu, lo, hi, variant=variant))
    return jax.jit(lambda G, R, st: jur.pnm_update(
        G, R, st, t, lam, BLOCK_Q, mu, lo, hi, variant=variant))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("k,d", BLOCK_SHAPES)
@pytest.mark.parametrize("rule", ["fista", "pnm"])
def test_block_ref_matches_jax_update_rules(rule, k, d, variant):
    """The plain block ops against k calls of the JAX package's
    ``fista_update`` / ``pnm_update`` (XLA path) on the same numpy inputs,
    to the JAX package's own prox tolerance (1e-5: float32 matrix-vector
    sums in another order, carried through at most 32 x 5 steps)."""
    G, R, wp, w = _block_inputs(k, d, 1000 + k + d)
    st = jur.IterState(w_prev=jnp.asarray(wp), w=jnp.asarray(w),
                       j=jnp.asarray(k, jnp.int32))
    update, want = _jax_update(rule, variant), []
    with jregistry.use("xla"):
        for i in range(k):
            st = update(jnp.asarray(G[i]), jnp.asarray(R[i]), st)
            want.append(np.asarray(st.w))
    Gt, Rt = torch.from_numpy(G), torch.from_numpy(R)
    scal = prox_scalars(*SCAL)
    got = (prox_ref.prox_step_block(Gt, Rt, torch.from_numpy(wp),
                                    torch.from_numpy(w), scal, j0=k,
                                    variant=variant)
           if rule == "fista" else
           prox_ref.prox_loop_block(Gt, Rt, torch.from_numpy(w), scal,
                                    Q=BLOCK_Q, variant=variant))
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-5,
                               atol=1e-5)


def _refusals():
    G, R, wp, w = (torch.from_numpy(a) for a in _block_inputs(3, 8, 0))
    s = prox_scalars(*SCAL)

    def step(G=G, R=R, wp=wp, w=w, s=s, j0=1, variant="l1"):
        return lambda: prox_ops.prox_step_block_cuda(G, R, wp, w, s, j0=j0,
                                                     variant=variant)

    def loop(G=G, R=R, z=w, s=s, Q=2, variant="l1"):
        return lambda: prox_ops.prox_loop_block_cuda(G, R, z, s, Q=Q,
                                                     variant=variant)
    return {
        "step-variant": (step(variant="l2"), "unknown prox variant"),
        "loop-variant": (loop(variant="l2"), "unknown prox variant"),
        "step-cpu": (step(), "must be on a CUDA device"),
        "loop-cpu": (loop(), "must be on a CUDA device"),
        "step-G-not-square": (step(G=G[:, :, :7]), r"G must be \(k, d, d\)"),
        "loop-G-2d": (loop(G=G[0]), r"G must be \(k, d, d\)"),
        "step-k0": (step(G=G[:0], R=R[:0]), "k >= 1"),
        "step-R": (step(R=R[:, :7]), r"R must have shape \(3, 8\)"),
        "loop-R-k": (loop(R=R[:2]), r"R must have shape \(3, 8\)"),
        "step-w_prev": (step(wp=wp[:7]), "w_prev must have shape"),
        "loop-z0": (loop(z=torch.ones(9)), "z0 must have shape"),
        "step-scal": (step(s=s[:4]), "scal must have shape"),
        "step-j0": (step(j0=-1), "j0 must be in"),
        "loop-Q": (loop(Q=-1), "Q must be >= 0"),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_prox_block_wrappers_refuse_bad_operands(case):
    call, match = _refusals()[case]
    with pytest.raises(ValueError, match=match):
        call()


def test_prox_block_ops_do_not_fall_back_to_the_plain_versions():
    G, R, wp, w = (torch.from_numpy(a) for a in _block_inputs(2, 8, 1))
    with registry.use("cuda"):
        with pytest.raises(RuntimeError, match="backend 'cuda' cannot run"):
            registry.dispatch("prox_step_block", G, R, wp, w,
                              prox_scalars(*SCAL), j0=1)
        with pytest.raises(RuntimeError, match="backend 'cuda' cannot run"):
            registry.dispatch("prox_loop_block", G, R, w,
                              prox_scalars(*SCAL), Q=2)
        with pytest.raises(RuntimeError, match="backend 'cuda' cannot run"):
            registry.dispatch("pdhg_block", G, R, w, w, prox_scalars(*SCAL),
                              torch.ones(1))


def test_prox_scalars_layout():
    scal = prox_scalars(torch.tensor(0.5), 0.1, mu=0.2, lo=-1.0, hi=1.0)
    assert scal.dtype == torch.float32 and scal.shape == (5,)
    np.testing.assert_array_equal(scal.numpy(),
                                  np.float32([0.5, 0.1, 0.2, -1.0, 1.0]))


def test_cpu_dispatch_runs_plain_versions_and_launches_nothing():
    reset_launch_counts()
    registry.reset_dispatch_counts()
    G, R, v = (torch.from_numpy(a) for a in _prox_inputs(8))
    registry.dispatch("gram", torch.from_numpy(_xs((2, 8, 16))))
    registry.dispatch("gram_gather", torch.from_numpy(_xs((9, 8))),
                      torch.tensor([[0, 3, 3, 8]]), 6, 0.25)
    registry.dispatch("prox_step", G, R, v, prox_scalars(*SCAL))
    registry.dispatch("prox_loop", G, R, v, prox_scalars(*SCAL), Q=2)
    registry.dispatch("prox_step_block", G[None], R[None], v, v,
                      prox_scalars(*SCAL), j0=1)
    registry.dispatch("prox_loop_block", G[None], R[None], v,
                      prox_scalars(*SCAL), Q=2)
    registry.dispatch("pdhg_block", G[None], R[None], v, v,
                      prox_scalars(*SCAL), torch.ones(1))
    q = torch.from_numpy(_xs((1, 4, 2, 16)))
    registry.dispatch("flash_attention", q, q, q, causal=True)
    (pq, kp, vp, t, n), _ = _paged_inputs(2, 4, 2, 16, 5, 3, "f32")
    registry.dispatch("paged_attention", pq, kp, vp, t, n)
    lse = torch.zeros(1, 2, 4)
    registry.dispatch("flash_dq", q, q, q, q, lse, lse)
    registry.dispatch("flash_dkv", q, q, q, q, lse, lse)
    x, dt = torch.ones(1, 5, 2, 4), torch.full((1, 5, 2), 0.1)
    A, B = -torch.ones(2), torch.ones(1, 5, 3)
    _, _, states = registry.dispatch("ssd", x, dt, A, B, B, chunk=4,
                                     return_states=True)
    registry.dispatch("ssd_bwd", x, dt, A, B, B, x, states, None, chunk=4)
    assert registry.dispatch_counts() == {
        ("gram", "torch"): 1, ("gram_gather", "torch"): 1,
        ("prox_step", "torch"): 1, ("prox_loop", "torch"): 1,
        ("prox_step_block", "torch"): 1, ("prox_loop_block", "torch"): 1,
        ("pdhg_block", "torch"): 1, ("flash_attention", "torch"): 1,
        ("paged_attention", "torch"): 1, ("flash_dq", "torch"): 1,
        ("flash_dkv", "torch"): 1, ("ssd", "torch"): 1,
        ("ssd_bwd", "torch"): 1}
    assert launch_counts() == {"gram": 0, "gram_gather": 0, "prox_step": 0,
                               "prox_loop": 0, "prox_step_block": 0,
                               "prox_loop_block": 0, "pdhg_block": 0,
                               "prox_rows": 0, "flash_attention": 0,
                               "paged_decode": 0, "flash_dq": 0,
                               "flash_dkv": 0, "ssd": 0, "ssd_bwd": 0}


# ------------------------------------------------------------- attention ---
#: the JAX package's own Pallas-vs-XLA tolerance for attention in float32
#: (tests/test_paged.py): float32 sums in another order
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
#: bf16 outputs: one rounding of the output, 2^-8 relative, on either side
BF16_TOL = dict(rtol=8e-3, atol=8e-3)


def _bhsd(a):
    return np.ascontiguousarray(np.swapaxes(a, 1, 2))


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", [
    (2, 4, 2, 12, 12, 16, True),       # smoke config's forward
    (1, 4, 2, 37, 300, 64, True),      # right-aligned, ragged
    (2, 6, 3, 50, 50, 32, False),      # not causal
    (1, 8, 8, 129, 129, 128, True),    # two q blocks, D=128
])
def test_flash_attention_ref_matches_pallas(B, Hq, Hkv, Sq, Skv, D, causal):
    """The plain version against the Pallas kernel (interpret mode) in
    float32, on the same numpy inputs; layouts (B,S,H,D) vs (B,H,S,D)."""
    q, k, v = (_xs((B, S, H, D), seed) for seed, S, H in
               ((1, Sq, Hq), (2, Skv, Hkv), (3, Skv, Hkv)))
    want = jfa_ops.flash_attention(
        *(jnp.asarray(_bhsd(a)) for a in (q, k, v)), causal=causal,
        interpret=True)
    got = fa_ref.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=causal)
    np.testing.assert_allclose(_bhsd(got.numpy()), np.asarray(want),
                               **ATTN_TOL)
    # and against the JAX package's own materialized-scores oracle
    oracle = jfa_ref.attention(*(jnp.asarray(_bhsd(a)) for a in (q, k, v)),
                               causal=causal)
    np.testing.assert_allclose(_bhsd(got.numpy()), np.asarray(oracle),
                               **ATTN_TOL)


def test_flash_attention_ref_matches_pallas_bf16():
    q, k, v = (_xs((2, 40, H, 64), seed) for seed, H in ((1, 8), (2, 4),
                                                          (3, 4)))
    jb = [jnp.asarray(_bhsd(a)).astype(jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jfa_ops.flash_attention(*jb, causal=True,
                                              interpret=True), np.float32)
    tb = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    got = fa_ref.flash_attention(*tb, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_bhsd(got.float().numpy()), want, **BF16_TOL)


#: the split's own bound: bf16 keeps 8 significant bits, so hi = bf16(p) is
#: within 2^-8 |p| of p and lo = bf16(p - hi) within 2^-8 of that
#: remainder: hi + lo is within 2^-16 |p|
SPLIT_REL = 2.0 ** -16
#: PV from the two halves against the float32 PV, normwise: what the float32
#: CUDA-core kernel's own summation order costs (near 1e-7)
SPLIT_PV_RTOL = 1e-5


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", [
    (2, 4, 2, 12, 12, 16, True),
    (1, 4, 2, 37, 300, 64, True),
    (2, 6, 3, 50, 50, 32, False),
    (1, 8, 8, 129, 129, 128, True),
])
def test_p_split_into_two_bf16_halves_keeps_float32_pv(B, Hq, Hkv, Sq, Skv,
                                                       D, causal):
    """The bf16 flash forward's numerical premise. It runs PV on the
    tensor cores, whose A operand is bf16, with p in float32 split into hi =
    bf16(p) and lo = bf16(p - hi). hi + lo carries p to 2^-16 relative, and
    hi V + lo V against bf16 V, summed in float32, stays within 1e-5
    normwise of the float32 PV; p rounded once to bf16 does not (each p
    moves by up to 2^-8 of itself, ~1.4e-3 normwise here), which is the
    reason for the split. The scores are this file's attention inputs in bf16,
    and the split's output matches the JAX package's float32 oracle at the
    attention tolerance."""
    q, k, v = (torch.from_numpy(_xs((B, S, H, D), seed)).bfloat16().float()
               for seed, S, H in ((1, Sq, Hq), (2, Skv, Hkv), (3, Skv, Hkv)))
    g = Hq // Hkv
    kh = k.repeat_interleave(g, dim=2).transpose(1, 2)     # (B, Hq, Skv, D)
    vh = v.repeat_interleave(g, dim=2).transpose(1, 2)
    s = q.transpose(1, 2) @ kh.transpose(-1, -2) * D ** -0.5
    if causal:
        rows = torch.arange(Sq)[:, None] + (Skv - Sq)
        s = s.masked_fill(torch.arange(Skv)[None, :] > rows, -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))           # float32
    hi = p.bfloat16()
    lo = (p - hi.float()).bfloat16()
    assert bool(((hi.float() + lo.float() - p).abs()
                 <= SPLIT_REL * p.abs()).all())
    want = p @ vh                                          # float32 PV
    split = hi.float() @ vh + lo.float() @ vh
    once = hi.float() @ vh

    def normwise(a):
        return float((a - want).abs().max() / want.abs().max())

    assert normwise(split) <= SPLIT_PV_RTOL
    assert normwise(once) > SPLIT_PV_RTOL
    out = (split / p.sum(-1, keepdim=True)).transpose(1, 2)
    oracle = jfa_ref.attention(*(jnp.asarray(_bhsd(a.numpy()))
                                 for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(_bhsd(out.numpy()), np.asarray(oracle),
                               **ATTN_TOL)


#: the share of bf16 outputs of the bf16 flash forward that may differ from
#: the float32-p plain version's, held on the card: float32 sums in another
#: order move an output across a bf16 rounding boundary a few times in a
#: thousand; p rounded once to bf16 moves more than a third of them
P_FLIP_LIMIT = 0.02


def _split_in_tiles(q, k, v, causal, tile=64):
    """The bf16 forward's arithmetic in float32 on the CPU: keys in tiles of
    ``tile``, the online softmax in base 2, PV as hi V + lo V with p split
    into hi = bf16(p) and lo = bf16(p - hi), l summing the float32 p."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qh = q.float().transpose(1, 2)
    kh = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vh = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    s = qh @ kh.transpose(-1, -2) * (D ** -0.5 * math.log2(math.e))
    if causal:
        rows = torch.arange(Sq)[:, None] + (Skv - Sq)
        s = s.masked_fill(torch.arange(Skv)[None, :] > rows, -math.inf)
    m = torch.full((B, Hq, Sq, 1), -math.inf)
    l = torch.zeros(B, Hq, Sq, 1)
    acc = torch.zeros(B, Hq, Sq, D)
    for j in range(0, Skv, tile):
        t = s[..., j:j + tile]
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        m0 = torch.where(torch.isfinite(m_new), m_new, 0.0)
        alpha = torch.exp2(m - m0)
        p = torch.exp2(t - m0)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        vt = vh[..., j:j + tile, :]
        acc = acc * alpha + hi @ vt + lo @ vt
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", [
    (1, 8, 4, 256, 256, 128, True),
    (2, 4, 2, 64, 333, 64, True),
    (1, 4, 2, 100, 300, 16, False),
])
def test_p_rounded_once_flips_bf16_outputs_the_split_keeps(B, Hq, Hkv, Sq,
                                                           Skv, D, causal):
    """The premise of the card check that the bf16 forward keeps p at
    float32 accuracy. On bf16 inputs, the share of bf16 outputs that differ
    from the float32-p plain version's (``flash_attention``) stays under
    ``P_FLIP_LIMIT`` for the kernel's arithmetic (tiles, base-2 online
    softmax, hi/lo split), and p rounded once (``flash_attention_p_rounded``)
    exceeds it: a kernel that dropped the lo products, or read V wrongly in
    them, fails the limit although its normwise error would pass 8e-3."""
    q, k, v = (torch.from_numpy(_xs((B, S, H, D), seed)).bfloat16()
               for seed, S, H in ((1, Sq, Hq), (2, Skv, Hkv), (3, Skv, Hkv)))
    want = fa_ref.flash_attention(q, k, v, causal=causal)
    once = fa_ref.flash_attention_p_rounded(q, k, v, causal=causal)
    split = _split_in_tiles(q, k, v, causal)

    def flips(got):
        return float((got != want).float().mean())

    assert flips(split) <= P_FLIP_LIMIT < flips(once)
    # the once-rounded version is the float32-p one but for that rounding
    np.testing.assert_allclose(once.float().numpy(), want.float().numpy(),
                               rtol=2 ** -7, atol=2 ** -7)


def _paged_inputs(B, Hq, Hkv, D, P, npages, kv, seed=0):
    """Numpy page pool with ragged valid lengths and table entries past
    valid pointing at page 0, the scratch page."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + B * npages
    valid = np.linspace(1, npages * P, B).astype(np.int32)
    perm = rng.permutation(np.arange(1, num_pages)).reshape(B, npages)
    table = np.where(np.arange(npages)[None] < -(-valid // P)[:, None],
                     perm, 0).astype(np.int32)
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    shape = (num_pages, P, Hkv, D)
    scales = {}
    if kv == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        scales = {n: rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32)
                  for n in ("k_scale", "v_scale")}
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(q), t(k), t(v), t(table), t(valid)), \
        {n: t(a) for n, a in scales.items()}


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("B,Hq,Hkv,D,P,npages", [
    (3, 6, 2, 16, 5, 3),       # odd page size, as tests/test_paged.py
    (2, 16, 8, 128, 16, 4),    # internlm2's heads, the engine's page size
    (4, 8, 1, 64, 3, 5),       # a group of 8
])
def test_paged_decode_ref_matches_pallas(kv, B, Hq, Hkv, D, P, npages):
    """The plain version against the Pallas paged kernel (interpret mode),
    float32 queries, float32 or int8 pools with scales."""
    args, scales = _paged_inputs(B, Hq, Hkv, D, P, npages, kv)
    j = [jnp.asarray(a.numpy()) for a in args]
    js = {n: jnp.asarray(a.numpy()) for n, a in scales.items()}
    want = jfa_ops.paged_flash_decode(*j, **js, interpret=True)
    got = fa_ref.paged_decode(*args, **scales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_paged_decode_ref_matches_pallas_bf16_pool():
    args, _ = _paged_inputs(3, 4, 2, 16, 5, 4, "f32", seed=1)
    q, k, v, t, n = args
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    want = jfa_ops.paged_flash_decode(
        *(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
          for a in (qb, kb, vb)), jnp.asarray(t.numpy()),
        jnp.asarray(n.numpy()), interpret=True)
    got = fa_ref.paged_decode(qb, kb, vb, t, n)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


def test_paged_decode_ref_ignores_rows_past_valid():
    """Rows at and past valid (page 0 among them) weigh exactly 0: garbage
    there changes no output bit. (The plain version multiplies them by a
    zero weight, so garbage means finite values here; the card test fills
    them with NaN, which the kernel never reads.)"""
    (q, k, v, t, n), _ = _paged_inputs(3, 4, 2, 16, 5, 4, "f32")
    before = fa_ref.paged_decode(q, k, v, t, n)
    k2, v2 = k.clone(), v.clone()
    k2[0] = v2[0] = 1e4
    for b in range(3):
        nb = int(n[b])
        pg, row = int(t[b, (nb - 1) // 5]), (nb - 1) % 5
        k2[pg, row + 1:] = v2[pg, row + 1:] = 1e4
    assert torch.equal(before, fa_ref.paged_decode(q, k2, v2, t, n))


@pytest.mark.parametrize("npages,P,want", [
    (64, 16, 8),       # the engine's table: 1,024 positions
    (80, 16, 10),      # past 8 chunks
    (205, 5, 9),       # 1,025 positions
    (8, 16, 1), (9, 16, 2), (1, 1, 1),
    (0, 16, 1),        # no page: one CTA still writes the zeros
])
def test_paged_splits_counts_chunks_of_128_positions(npages, P, want):
    assert fa_ops.PAGED_CHUNK == 128
    assert fa_ops.paged_splits(npages, P) == want


def test_paged_map_key_names_addresses_shape_and_dtype():
    (_, k, v, _, _), _ = _paged_inputs(2, 4, 2, 16, 5, 3, "f32")
    key = fa_ops._paged_map_key(k, v)
    assert key == fa_ops._paged_map_key(k.view(k.shape), v)
    assert key != fa_ops._paged_map_key(v, k)
    assert key != fa_ops._paged_map_key(k.clone(), v)
    assert key != fa_ops._paged_map_key(k.view(torch.int32), v)
    assert key != fa_ops._paged_map_key(k.view(-1, 5, 2, 16)[:6], v[:6])
    # the engine's layers: slices of one (layers, pages, P, Hkv, D) pool
    pool = torch.zeros(3, 7, 5, 2, 16)
    assert len({fa_ops._paged_map_key(pool[i], pool[i])
                for i in range(3)}) == 3


def test_paged_maps_are_encoded_once_per_key(monkeypatch):
    """The tensor maps are encoded at a key's first call and then reused;
    past the cache's bound it starts over."""
    calls = []

    def encode(buf, ptr, kv_type, num_pages, P, Hkv, D):
        calls.append((ptr, kv_type, num_pages, P, Hkv, D))
        return 0

    monkeypatch.setattr(fa_ops, "_MAPS", {})
    monkeypatch.setattr(fa_ops, "_MAX_MAPS", 2)
    monkeypatch.setattr(fa_ops._build, "function", lambda *a: encode)
    pools = [torch.zeros(4, 5, 2, 16, dtype=torch.bfloat16)
             for _ in range(3)]
    first = fa_ops._paged_maps(pools[0], pools[1])
    assert [c[1:] for c in calls] == [(1, 4, 5, 2, 16)] * 2
    assert [c[0] for c in calls] == [pools[0].data_ptr(),
                                     pools[1].data_ptr()]
    kmap, vmap, bufs = first
    assert [kmap, vmap] == [ctypes.addressof(b) for b in bufs]
    assert all(len(b) == 128 for b in bufs)
    assert fa_ops._paged_maps(pools[0], pools[1]) is first
    assert len(calls) == 2
    fa_ops._paged_maps(pools[1], pools[2])
    fa_ops._paged_maps(pools[2], pools[0])          # past the bound
    assert len(fa_ops._MAPS) == 1 and len(calls) == 6


def test_paged_scratch_keeps_zeroed_tickets_and_grows(monkeypatch):
    monkeypatch.setattr(fa_ops, "_SCRATCH", {})
    cpu = torch.device("cpu")
    part, tickets = fa_ops._paged_scratch(cpu, 0, 100, 8)
    assert part.numel() == 100 and part.dtype == torch.float32
    assert tickets.dtype == torch.int32 and not tickets.any()
    p2, t2 = fa_ops._paged_scratch(cpu, 0, 50, 4)
    assert p2 is part and t2 is tickets
    p3, t3 = fa_ops._paged_scratch(cpu, 0, 200, 8)
    assert p3.numel() == 200 and t3 is tickets
    p4, t4 = fa_ops._paged_scratch(cpu, 0, 10, 16)
    assert p4 is p3 and t4.numel() == 16 and not t4.any()
    p5, _ = fa_ops._paged_scratch(cpu, 1, 10, 1)   # another stream
    assert p5 is not p3


def test_attention_cuda_wrappers_reject_cpu_tensors():
    q = torch.from_numpy(_xs((1, 4, 2, 16)))
    with pytest.raises(ValueError, match="CUDA device"):
        fa_ops.flash_attention_cuda(q, q, q)
    (pq, kp, vp, t, n), _ = _paged_inputs(2, 4, 2, 16, 5, 3, "f32")
    with pytest.raises(ValueError, match="CUDA device"):
        fa_ops.paged_decode_cuda(pq, kp, vp, t, n)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        fa_ops.flash_dq_cuda(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA device"):
        fa_ops.flash_dkv_cuda(q, q, q, q, lse, lse)
    assert fa_ops.flash_attention_cuda.launches == 0
    assert fa_ops.paged_decode_cuda.launches == 0
    assert fa_ops.flash_dq_cuda.launches == 0
    assert fa_ops.flash_dkv_cuda.launches == 0


# ------------------------------------------------- attention's backward ---
#: the JAX package's own grad tolerances for flash attention
#: (tests/test_kernels.py, _GRAD_TOL["flash_attention"]): float32, and bf16
#: cotangents compounding the forward's rounding
GRAD_TOL = {"float32": dict(atol=5e-4), "bfloat16": dict(atol=0.5,
                                                         rtol=5e-2)}
BWD_CASES = [
    (1, 4, 2, 13, 13, 16, True),      # GQA group 2, odd S
    (1, 4, 2, 7, 20, 16, True),       # Sq < Skv, right-aligned
    (2, 6, 2, 9, 17, 32, False),      # group 3, not causal
]


def _bwd_inputs(B, Hq, Hkv, Sq, Skv, D, seed=0):
    """q, k, v, do (model layout, numpy float32)."""
    return [_xs((B, S, H, D), seed + i) for i, (S, H) in enumerate(
        ((Sq, Hq), (Skv, Hkv), (Skv, Hkv), (Sq, Hq)))]


def _plain_fwd_bwd(q, k, v, do, causal):
    """The port's plain versions end to end: (o, lse, dq, dk, dv)."""
    o, lse = fa_ref.flash_attention_lse(q, k, v, causal=causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa_ref.flash_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = fa_ref.flash_dkv(q, k, v, do, lse, delta, causal=causal)
    return o, lse, dq, dk, dv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", BWD_CASES)
def test_flash_backward_ref_matches_pallas(B, Hq, Hkv, Sq, Skv, D, causal,
                                           dtype):
    """The plain lse forward, dq and dk/dv against the JAX package's
    custom-VJP pair ``flash_attention_fwd``/``flash_attention_bwd`` (Pallas
    in interpret mode) on the same numpy inputs: o and lse at the forward's
    tolerance (float32), the grads at the JAX package's grad tolerance."""
    arrs = _bwd_inputs(B, Hq, Hkv, Sq, Skv, D)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(_bhsd(a)).astype(jdt) for a in arrs)
    with jregistry.use("pallas"):
        jo, res = jfa_ops.flash_attention_fwd(jq, jk, jv, causal=causal,
                                              interpret=True)
        jgrads = jfa_ops.flash_attention_bwd(res, jdo, causal=causal,
                                             interpret=True)
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrs)
    o, lse, *grads = _plain_fwd_bwd(q, k, v, do, causal)
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    f32 = dict(ATTN_TOL if dtype == "float32" else BF16_TOL)
    np.testing.assert_allclose(_bhsd(o.float().numpy()),
                               np.asarray(jo, np.float32), **f32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[4])[..., 0],
                               **ATTN_TOL)
    for name, got, want, t in zip(("dq", "dk", "dv"), grads, jgrads,
                                  (q, k, v)):
        assert got.dtype == t.dtype and got.shape == t.shape, name
        np.testing.assert_allclose(_bhsd(got.float().numpy()),
                                   np.asarray(want, np.float32),
                                   **GRAD_TOL[dtype], err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", BWD_CASES)
def test_flash_attention_grad_matches_jax_xla_grad(B, Hq, Hkv, Sq, Skv, D,
                                                   causal, dtype):
    """Grads through the port's attention (the autograd Function over the
    plain versions) against ``jax.grad`` through the JAX model's attention
    with the XLA backend, at the JAX package's grad tolerances."""
    arrs = _bwd_inputs(B, Hq, Hkv, Sq, Skv, D, seed=5)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in arrs)

    def jloss(q, k, v):
        o = j_attention(q, k, v, causal=causal)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32))

    with jregistry.use("xla"):
        want = jax.grad(jloss, (0, 1, 2))(jq, jk, jv)
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype))
               .requires_grad_() for a in arrs[:3])
    do = torch.from_numpy(arrs[3]).to(q.dtype)
    registry.reset_dispatch_counts()
    o = fa_ops.flash_attention(q, k, v, causal=causal)
    (o.float() * do.float()).sum().backward()
    assert registry.dispatch_counts() == {
        ("flash_attention", "torch"): 1, ("flash_dq", "torch"): 1,
        ("flash_dkv", "torch"): 1}
    for name, t, w in zip(("dq", "dk", "dv"), (q, k, v), want):
        assert t.grad.dtype == t.dtype, name
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(w, np.float32),
                                   **GRAD_TOL[dtype], err_msg=name)


def _bwd_split_in_tiles(q, k, v, do, lse, delta, causal, tile=64):
    """The bf16 backward kernels' arithmetic in float32 on the CPU: p =
    exp2(s * scale * log2 e - lse * log2 e) on visible entries (exp2 of the
    select, so masked entries are exactly 0) and ds = p (dp - delta), both
    split into hi = bf16(x) and lo = bf16(x - hi); dq sums hi k + lo k over
    the key tiles in order, dk and dv sum hi q + lo q and hi do + lo do over
    the group's query heads, then the q tiles, in order; one rounding to
    the inputs' dtype at the end."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale, log2e = D ** -0.5, math.log2(math.e)
    qh, doh = (t.float().transpose(1, 2) for t in (q, do))
    kh, vh = (t.float().repeat_interleave(G, dim=2).transpose(1, 2)
              for t in (k, v))
    x = qh @ kh.transpose(-1, -2) * (scale * log2e) - lse[..., None] * log2e
    vis = fa_ref._visible(Sq, Skv, causal, q.device)
    p = torch.exp2(torch.where(vis, x, -math.inf))
    ds = p * (doh @ vh.transpose(-1, -2) - delta[..., None])

    def halves(t):
        hi = t.bfloat16().float()
        return hi, (t - hi).bfloat16().float()

    (p_hi, p_lo), (ds_hi, ds_lo) = halves(p), halves(ds)
    dq = torch.zeros(B, Hq, Sq, D)
    for j in range(0, Skv, tile):
        kt = kh[..., j:j + tile, :]
        dq = dq + ds_hi[..., j:j + tile] @ kt
        dq = dq + ds_lo[..., j:j + tile] @ kt

    def grouped(t):                                   # (B, Hkv, G, S, ...)
        return t.reshape(B, Hkv, G, *t.shape[2:])

    qg, dog = grouped(qh), grouped(doh)
    phi, plo, dhi, dlo = (grouped(t) for t in (p_hi, p_lo, ds_hi, ds_lo))
    dk = torch.zeros(B, Hkv, Skv, D)
    dv = torch.zeros(B, Hkv, Skv, D)
    for g in range(G):
        for i in range(0, Sq, tile):
            r = slice(i, i + tile)
            for half in (phi, plo):
                dv = dv + half[:, :, g, r].transpose(-1, -2) @ \
                    dog[:, :, g, r]
            for half in (dhi, dlo):
                dk = dk + half[:, :, g, r].transpose(-1, -2) @ \
                    qg[:, :, g, r]
    return ((dq * scale).transpose(1, 2).to(q.dtype),
            (dk * scale).transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _lse_delta(q, k, v, do, causal):
    """The plain forward's lse and delta = rowsum(do * o), as the model's
    backward hands them to the kernels."""
    o, lse = fa_ref.flash_attention_lse(q, k, v, causal=causal)
    return lse, (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", BWD_CASES)
def test_backward_split_in_tiles_matches_pallas(B, Hq, Hkv, Sq, Skv, D,
                                                causal, dtype):
    """The bf16 backward kernels' arithmetic (tiles of 64, base-2 exp with
    the folded scale, p and ds as bf16 hi + lo, float32 sums, the GQA sum
    over heads, then tiles) against the JAX package's
    ``flash_attention_bwd`` through Pallas in interpret mode, on the same
    numpy inputs, at the JAX package's grad tolerance."""
    arrs = _bwd_inputs(B, Hq, Hkv, Sq, Skv, D)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(_bhsd(a)).astype(jdt) for a in arrs)
    with jregistry.use("pallas"):
        _, res = jfa_ops.flash_attention_fwd(jq, jk, jv, causal=causal,
                                             interpret=True)
        jgrads = jfa_ops.flash_attention_bwd(res, jdo, causal=causal,
                                             interpret=True)
    q, k, v, do = (torch.from_numpy(a).to(getattr(torch, dtype))
                   for a in arrs)
    grads = _bwd_split_in_tiles(q, k, v, do, *_lse_delta(q, k, v, do,
                                                         causal), causal)
    for name, got, want, t in zip(("dq", "dk", "dv"), grads, jgrads,
                                  (q, k, v)):
        assert got.dtype == t.dtype and got.shape == t.shape, name
        np.testing.assert_allclose(_bhsd(got.float().numpy()),
                                   np.asarray(want, np.float32),
                                   **GRAD_TOL[dtype], err_msg=name)


#: the bf16 backward's shares of differing outputs are held to the
#: forward's limit (P_FLIP_LIMIT above): the kernels' arithmetic moves a few
#: in a thousand, p and ds rounded once to bf16 about two in five
FLIP_CASES = [
    (1, 8, 4, 256, 256, 128, True),
    (2, 4, 2, 64, 333, 64, True),
    (1, 4, 2, 100, 300, 16, False),
]


def _flip_shares(B, Hq, Hkv, Sq, Skv, D, causal, grads_of):
    """The share of bf16 dq, dk and dv outputs of ``grads_of`` that differ
    from the float32 plain versions', on bf16 inputs."""
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _bwd_inputs(B, Hq, Hkv, Sq, Skv, D, seed=21))
    lse, delta = _lse_delta(q, k, v, do, causal)
    want = (fa_ref.flash_dq(q, k, v, do, lse, delta, causal=causal),
            *fa_ref.flash_dkv(q, k, v, do, lse, delta, causal=causal))
    got = grads_of(q, k, v, do, lse, delta, causal)
    return [float((g != w).float().mean()) for g, w in zip(got, want)]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", FLIP_CASES)
def test_backward_split_keeps_bf16_outputs_of_float32_p_and_ds(
        B, Hq, Hkv, Sq, Skv, D, causal):
    """The premise of the card check that the bf16 backward keeps p and ds
    at float32 accuracy: with both split into hi + lo, the share of bf16
    dq, dk and dv outputs that differ from the float32 plain versions'
    stays under ``P_FLIP_LIMIT``."""
    shares = _flip_shares(B, Hq, Hkv, Sq, Skv, D, causal,
                          _bwd_split_in_tiles)
    assert max(shares) <= P_FLIP_LIMIT, shares


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", FLIP_CASES)
def test_p_and_ds_rounded_once_flip_bf16_grads_past_the_limit(
        B, Hq, Hkv, Sq, Skv, D, causal):
    """With p and ds rounded once to bf16 (``flash_dq_rounded``,
    ``flash_dkv_rounded``), the share of differing dq, dk and dv outputs
    exceeds ``P_FLIP_LIMIT``: a kernel that dropped the lo products fails
    the limit although its normwise error would pass 8e-3."""

    def rounded(q, k, v, do, lse, delta, causal):
        return (fa_ref.flash_dq_rounded(q, k, v, do, lse, delta,
                                        causal=causal),
                *fa_ref.flash_dkv_rounded(q, k, v, do, lse, delta,
                                          causal=causal))

    shares = _flip_shares(B, Hq, Hkv, Sq, Skv, D, causal, rounded)
    assert min(shares) > P_FLIP_LIMIT, shares


def test_padded_head_dim_takes_multiples_of_8_up_to_128():
    assert [fa_ops.padded_head_dim(d, "t") for d in (8, 16, 24, 48, 80,
                                                      128)] == \
        [16, 16, 32, 64, 128, 128]
    for d in (44, 136, 0):
        with pytest.raises(ValueError, match="head dim"):
            fa_ops.padded_head_dim(d, "t")


@pytest.mark.parametrize("op", ["flash_attention", "flash_dq", "flash_dkv",
                                "paged_decode"])
def test_call_padded_matches_the_plain_versions_at_d80(op):
    """The CUDA wrappers run a head dim off the built ones (zamba2's 80)
    zero-padded to the next (128), with the true D's scale, and slice the
    outputs back: through the plain versions that gives the unpadded
    result, lse included."""
    D = 80
    q, k, v, do = (torch.from_numpy(a)
                   for a in _bwd_inputs(2, 4, 2, 37, 45, D, seed=13))
    lse, delta = _lse_delta(q, k, v, do, True)
    if op == "flash_attention":
        got = fa_ops.call_padded(fa_ref.flash_attention, (q, k, v),
                                 causal=True, return_lse=True)
        want = fa_ref.flash_attention(q, k, v, causal=True, return_lse=True)
    elif op == "flash_dq":
        got = (fa_ops.call_padded(fa_ref.flash_dq, (q, k, v, do),
                                  (lse, delta), causal=True),)
        want = (fa_ref.flash_dq(q, k, v, do, lse, delta, causal=True),)
    elif op == "flash_dkv":
        got = fa_ops.call_padded(fa_ref.flash_dkv, (q, k, v, do),
                                 (lse, delta), n_out=2, causal=True)
        want = fa_ref.flash_dkv(q, k, v, do, lse, delta, causal=True)
    else:
        (pq, kp, vp, t, n), scales = _paged_inputs(3, 4, 2, D, 5, 3, "int8")
        got = (fa_ops.call_padded(fa_ref.paged_decode, (pq, kp, vp), (t, n),
                                  **scales),)
        want = (fa_ref.paged_decode(pq, kp, vp, t, n, **scales),)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)


def _autograd_attention(q, k, v, causal):
    """Attention as plain differentiable float64 PyTorch, for autograd."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k) * D ** -0.5
    s = s.masked_fill(~fa_ref._visible(Sq, Skv, causal, q.device),
                      float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    return torch.einsum("bkgqt,btkd->bqkgd", p, v).reshape(B, Sq, Hq, D)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal",
                         BWD_CASES + [(1, 4, 2, 12, 5, 16, True)])
def test_flash_attention_function_matches_torch_autograd(B, Hq, Hkv, Sq,
                                                         Skv, D, causal):
    """The autograd Function (torch backend: the plain lse forward, dq,
    dk/dv) against torch autograd of plain attention on the same float32
    inputs; the last case has rows that see no key (Sq > Skv, causal):
    output 0 and finite, zero grads there. Float32 sums in another order:
    the forward's tolerance, 2e-5."""
    arrs = _bwd_inputs(B, Hq, Hkv, Sq, Skv, D, seed=9)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    do = torch.from_numpy(arrs[3])
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    gq, gk, gv = torch.autograd.grad(got, (q, k, v), do)
    q64, k64, v64 = (torch.from_numpy(a).double().requires_grad_()
                     for a in arrs[:3])
    want = _autograd_attention(q64, k64, v64, causal)
    wq, wk, wv = torch.autograd.grad(want, (q64, k64, v64), do.double())
    for g, w in ((got, want), (gq, wq), (gk, wk), (gv, wv)):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.detach().numpy(),
                                   w.detach().float().numpy(), **ATTN_TOL)
    if Sq > Skv and causal:
        blind = Sq - Skv                 # rows that see no key
        assert float(got.detach()[:, :blind].abs().max()) == 0.0
        assert float(gq[:, :blind].abs().max()) == 0.0


def test_flash_attention_without_grad_launches_the_plain_op():
    """No grad (inference): the op as it is, no lse, no Function."""
    q = torch.from_numpy(_xs((1, 6, 4, 16))).requires_grad_()
    registry.reset_dispatch_counts()
    with torch.no_grad():
        o = fa_ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    assert o.grad_fn is None
    o = fa_ops.flash_attention(q.detach(), q.detach()[:, :, :2],
                               q.detach()[:, :, :2])
    assert o.grad_fn is None
    assert registry.dispatch_counts() == {("flash_attention", "torch"): 2}


# ------------------------------------------------------------ gram's VJP ---
#: the JAX package's own grad tolerance for gram, float32
#: (tests/test_kernels.py, _GRAD_TOL["gram"])
GRAM_GRAD_TOL = dict(atol=1e-2, rtol=1e-4)


@pytest.mark.parametrize("shape", [(8, 129), (3, 18, 200)])
def test_gram_vjp_matches_jax_grad_through_pallas(shape):
    """dXs = (dG + dG^T) Xs of the port's gram Function (torch backend)
    against ``jax.grad`` through the JAX registry's Pallas gram (interpret
    mode on the CPU) and its custom VJP, for a loss that is not symmetric
    in G."""
    Xs = _xs(shape, seed=11)
    W = _xs(shape[-2:-1] * 2, seed=12)

    def jloss(X):
        if X.ndim == 2:
            return jnp.sum(jregistry.dispatch("gram", X) * W)
        return sum(jnp.sum(jregistry.dispatch("gram", X[j]) * W)
                   for j in range(X.shape[0]))

    with jregistry.use("pallas"):
        want = jax.grad(jloss)(jnp.asarray(Xs))
    X = torch.from_numpy(Xs).requires_grad_()
    registry.reset_dispatch_counts()
    G = gram_ops.gram(X)
    (G * torch.from_numpy(W)).sum().backward()
    assert registry.dispatch_counts() == {("gram", "torch"): 1}
    assert X.grad.dtype == torch.float32
    np.testing.assert_allclose(X.grad.numpy(), np.asarray(want),
                               **GRAM_GRAD_TOL)

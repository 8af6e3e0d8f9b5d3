"""The port's kernels against the JAX package's: each plain PyTorch version
(the path CPU tensors take) against the Pallas kernel in interpret mode and
against the JAX ref, on the same numpy inputs; and the CUDA wrappers' checks
and chunking. The CUDA kernels themselves are held against their plain
versions on the card by tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gram import ops as jgram_ops, ref as jgram_ref
from repro.kernels.prox_step import ops as jprox_ops, ref as jprox_ref
from repro_torch.kernels import launch_counts, registry, reset_launch_counts
from repro_torch.kernels.gram import ops as gram_ops, ref as gram_ref
from repro_torch.kernels.prox_step import ops as prox_ops, ref as prox_ref
from repro_torch.kernels.prox_step.ops import prox_scalars

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
    registry.dispatch("prox_step", G, R, v, prox_scalars(*SCAL))
    registry.dispatch("prox_loop", G, R, v, prox_scalars(*SCAL), Q=2)
    assert registry.dispatch_counts() == {
        ("gram", "torch"): 1, ("prox_step", "torch"): 1,
        ("prox_loop", "torch"): 1}
    assert launch_counts() == {"gram": 0, "prox_step": 0, "prox_loop": 0}

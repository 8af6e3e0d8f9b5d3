"""The port's CUDA kernels and solvers on an NVIDIA Hopper card: each kernel
against its plain PyTorch version, one draw's Gram bits independent of the
batch, and CA == classical through the kernels. Every test here needs the
card and skips without one.

This file imports neither JAX nor ``repro``, so it also runs where only the
port is installed:

  PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import SolverConfig, ca_sfista, ca_spnm, sfista, spnm
from repro_torch.data import make_lasso_data
from repro_torch.kernels import registry
from repro_torch.kernels.gram import ops as gram_ops, ref as gram_ref
from repro_torch.kernels.prox_step import ops as prox_ops, ref as prox_ref
from repro_torch.kernels.prox_step.ops import prox_scalars

pytestmark = pytest.mark.cuda

VARIANTS = ("l1", "elastic_net", "box", "none")
SCAL = (0.05, 0.02, 0.3, -0.1, 0.2)     # [t, lam, mu, lo, hi]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card (torch.cuda.is_available() "
                    "is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device)


def _normwise(got, want):
    """max |got - want| / max |want|: float32 sums in another order."""
    return float((got - want).abs().max() / want.abs().max())


#: gram vs its float64-summed plain version, normwise: float32 summation in
#: m-chunks stays near 3e-7 at these shapes, a kernel that multiplied in
#: TF32 would read 4e-6 or more
GRAM_RTOL = 2e-6


@pytest.mark.parametrize("k,d,m", [(1, 54, 5810), (4, 18, 50_000),
                                   (3, 61, 129), (2, 130, 777), (1, 8, 1)])
def test_gram_cuda_matches_plain(cuda, k, d, m):
    Xs = _randn((k, d, m), k + d + m, cuda)
    got = gram_ops.gram_cuda(Xs)
    torch.cuda.synchronize()
    assert _normwise(got, gram_ref.gram(Xs)) <= GRAM_RTOL


def test_gram_cuda_bits_do_not_depend_on_batch_size(cuda):
    Xs = _randn((8, 54, 5810), 1, cuda)
    batch = gram_ops.gram_cuda(Xs)
    for j in range(8):
        assert torch.equal(gram_ops.gram_cuda(Xs[j]), batch[j])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("d", [18, 54, 61, 300])
def test_prox_cuda_matches_plain(cuda, variant, d):
    A = _randn((d, d), d, cuda)
    G = (A @ A.T / d).contiguous()
    R, v = _randn(d, d + 1, cuda), _randn(d, d + 2, cuda)
    scal = prox_scalars(*SCAL, device=cuda)
    step = prox_ops.prox_step_cuda(G, R, v, scal, variant=variant)
    loop = prox_ops.prox_loop_cuda(G, R, v, scal, Q=5, variant=variant)
    torch.cuda.synchronize()
    torch.testing.assert_close(step, prox_ref.prox_step(
        G, R, v, scal, variant=variant), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(loop, prox_ref.prox_loop(
        G, R, v, scal, Q=5, variant=variant), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pair", [(sfista, ca_sfista), (spnm, ca_spnm)],
                         ids=["fista", "pnm"])
def test_ca_matches_classical_through_the_kernels(cuda, pair):
    problem, _ = make_lasso_data(0, d=54, n=20_000, device=cuda)
    cfg = SolverConfig(T=64, k=16, b=0.1, step_size=0.5)
    kernels.reset_launch_counts()
    registry.reset_dispatch_counts()
    w_cl = pair[0](problem, cfg, 3)
    w_ca = pair[1](problem, cfg, 3)
    launches = kernels.launch_counts()
    assert launches["gram"] == cfg.T + cfg.T // cfg.k
    assert launches["prox_step"] + launches["prox_loop"] == 2 * cfg.T
    assert all(b == "cuda" for _, b in registry.dispatch_counts())
    assert float((w_ca - w_cl).abs().max()) <= 5e-6
    with registry.use("torch"):
        w_plain = pair[0](problem, cfg, 3)
    assert float((w_cl - w_plain).abs().max()) <= 1e-4

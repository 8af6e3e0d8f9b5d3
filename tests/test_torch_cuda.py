"""The port's CUDA kernels, solvers, serving and training paths on an NVIDIA
Hopper card: each kernel against its plain PyTorch version, one draw's Gram
bits independent of the batch, the attention backward's and the SSD
scans' bits independent of the launch and the batch, the block prox
kernels (``pdhg_block`` too, and the rows route at large d) bitwise their
one-step instances, CA == classical through the kernels (PDHG and BCD
too), the distributed solvers in an NCCL group of one, the sync audit on
the card (its reads, the runtime's sync-debug cross-check, the host-loop
solves' T/k round trips and the engine's audit equal to its stats), and at
the smoke configs the engine's k-invariance,
teacher-forced decode against the forward and the train step through the
backward kernels (internlm2) and through the SSD kernels (mamba2); the
attention kernels at the other families' shapes (whisper's non-causal
encoder and its cross-attention down to a single query, qwen2-vl's group
of 6, granite's train step at D=64) and granite's and whisper's forward on
the card against the CPU. Every test here needs the card and skips
without one.

This file imports neither JAX nor ``repro``, so it also runs where only the
port is installed:

  PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels, obs
from repro_torch.configs import get_arch, smoke_config
from repro_torch.core import SolverConfig, ca_sfista, ca_spnm, sfista, spnm
from repro_torch.core import sstep, update_rules as ur
from repro_torch.core.sampling import gather_columns
from repro_torch.data import make_lasso_data
from repro_torch.kernels import registry
from repro_torch.kernels.gram import ops as gram_ops, ref as gram_ref
from repro_torch.kernels.prox_step import ops as prox_ops, ref as prox_ref
from repro_torch.kernels.prox_step.ops import prox_scalars
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.kernels.ssd import ops as ssd_ops, ref as ssd_ref
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models import decode_step, forward, init_cache, init_params
from repro_torch.obs.sync_audit import block_until_ready
from repro_torch.serve import (Engine, PagedCachePool, Request,
                               SamplingParams, SlotSampling, host_fold_in,
                               sample_tokens)
from repro_torch.serve import sampling as tsampling
from repro_torch.tree import tree_map

pytestmark = pytest.mark.cuda

VARIANTS = ("l1", "elastic_net", "box", "none")
SCAL = (0.05, 0.02, 0.3, -0.1, 0.2)     # [t, lam, mu, lo, hi]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card (torch.cuda.is_available() "
                    "is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # XLA sums bf16 products in float32; cuBLAS may not unless told
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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


def _gather_inputs(k, r, m, seed, device):
    """Sample-major rows (n, r_pad), n = m // 2 + 3, padded with nonzero
    values (they take part in nothing), and k draws (k, m) with
    replacement, each with its first row drawn again last."""
    rng = np.random.default_rng(seed)
    n = m // 2 + 3
    rows = rng.standard_normal((n, -(-r // 4) * 4 + 4)).astype(np.float32)
    idx = rng.integers(0, n, (k, m))
    idx[:, -1] = idx[:, 0]
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(idx).to(device))


#: (k, r, m) of gram_gather's card tests: few CTAs (k x chunks < 1024:
#: the small tiles) and many (the large tiles, as at the CA blocks)
GATHER_SHAPES = [(1, 54, 5810), (4, 18, 50_000), (3, 61, 129), (2, 130, 777),
                 (1, 8, 1), (32, 55, 5810), (2, 19, 500), (32, 55, 20_000),
                 (32, 19, 20_000), (16, 130, 40_000)]


@pytest.mark.parametrize("k,r,m", GATHER_SHAPES)
def test_gram_gather_cuda_matches_plain(cuda, k, r, m):
    rows, idx = _gather_inputs(k, r, m, k + r + m, cuda)
    G, R = gram_ops.gram_gather_cuda(rows, idx, r, 1.0 / m)
    want_G, want_R = gram_ref.gram_gather(rows, idx, r, 1.0 / m)
    torch.cuda.synchronize()
    assert G.shape == (k, r - 1, r - 1) and R.shape == (k, r - 1)
    got = torch.cat([G.flatten(1), R], 1)
    assert _normwise(got, torch.cat([want_G.flatten(1), want_R], 1)) \
        <= GRAM_RTOL


@pytest.mark.parametrize("k,r,m", [(4, 55, 5810), (3, 19, 20_000),
                                   (3, 61, 129), (2, 130, 777),
                                   (32, 55, 20_000), (32, 19, 20_000)])
def test_gram_gather_cuda_is_gram_cuda_of_the_gathered_rows(cuda, k, r, m):
    """The fused kernel keeps gram's summation order: its G and R are
    bitwise gram_cuda's over the gathered copy, before and after the
    scaling."""
    rows, idx = _gather_inputs(k, r, m, 7, cuda)
    Ga = gram_ops.gram_cuda(gather_columns(rows[:, :r].T, idx))
    d = r - 1
    for inv_m in (1.0, 1.0 / m):
        G, R = gram_ops.gram_gather_cuda(rows, idx, r, inv_m)
        want = Ga * inv_m
        assert torch.equal(G, want[:, :d, :d])
        assert torch.equal(R, want[:, :d, d])


@pytest.mark.parametrize("r", [55, 19])
def test_gram_gather_cuda_bits_do_not_depend_on_batch_size(cuda, r):
    """A batch of 32 runs the large tiles, one draw alone the small ones:
    the same bits."""
    rows, idx = _gather_inputs(32, r, 20_000, 1, cuda)
    G, R = gram_ops.gram_gather_cuda(rows, idx, r, 1.0 / 20_000)
    for j in (0, 13, 31):
        Gj, Rj = gram_ops.gram_gather_cuda(rows, idx[j:j + 1], r,
                                           1.0 / 20_000)
        assert torch.equal(Gj[0], G[j]) and torch.equal(Rj[0], R[j])


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


def _dual_err(u, want_u, want_w, sigma):
    """PDHG's dual iterate against the plain one, normwise at the scale it
    is computed at: u+ = x - sigma prox(x / sigma) with x near sigma w+, so
    max(|u+|, sigma |w+|) (at variant "none" u+ is rounding noise around 0
    and its own maximum no scale)."""
    scale = max(float(want_u.abs().max()),
                float(sigma) * float(want_w.abs().max()))
    return float((u - want_u).abs().max()) / scale


def _rows_block(k, d, seed, device):
    """A (k, d, d) block for the rows route: symmetric positive definite up
    to d = 4096, scaled Gaussian above (any G holds the arithmetic)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if d <= 4096:
        A = torch.randn(k, d, d, generator=gen, device=device)
        G = (A @ A.transpose(1, 2) / d).contiguous()
        del A
    else:
        G = torch.randn(k, d, d, generator=gen, device=device) / d ** 0.5
    vecs = [torch.randn(d, generator=gen, device=device) for _ in range(3)]
    return G, torch.randn(k, d, generator=gen, device=device), vecs


@pytest.mark.parametrize("d", [4096, 20_480])
def test_rows_route_is_bitwise_its_k1_instance_and_matches_plain(cuda, d):
    """Above the threshold every prox op takes the rows route, past the
    one-CTA limit too (d = 20,480 > 19,368): a block is bitwise k launches
    of its k = 1 instance, and each step within 1e-5 of the plain step
    from the kernel's own previous iterate, normwise."""
    assert prox_ops.rows_route(d)
    k = 2
    G, R, (wp, w, u) = _rows_block(k, d, d, cuda)
    u = u * 0.01
    scal = prox_scalars(*SCAL, device=cuda)
    sigma = torch.tensor([0.5 / SCAL[0]], device=cuda)
    variants = VARIANTS if d <= 4096 else ("l1",)
    for variant in variants:
        kernels.reset_launch_counts()
        W = prox_ops.prox_step_block_cuda(G, R, wp, w, scal, j0=5,
                                          variant=variant)
        Z = prox_ops.prox_loop_block_cuda(G, R, w, scal, Q=3,
                                          variant=variant)
        P, pu = prox_ops.pdhg_block_cuda(G, R, w, u, scal, sigma,
                                         variant=variant)
        launches = kernels.launch_counts()
        assert launches["prox_rows"] == k + k * 3 + k
        assert launches["prox_step_block"] + launches["prox_loop_block"] \
            + launches["pdhg_block"] == 0
        a, b, z, x, c, pd = wp, w, w, w, u, [(w, u)]
        for i in range(k):
            a, b = b, prox_ops.prox_step_block_cuda(
                G[i:i + 1], R[i:i + 1], a, b, scal, j0=5 + i,
                variant=variant)[0]
            z = prox_ops.prox_loop_cuda(G[i], R[i], z, scal, Q=3,
                                        variant=variant)
            x1, c = prox_ops.pdhg_block_cuda(G[i:i + 1], R[i:i + 1], x, c,
                                             scal, sigma, variant=variant)
            x = x1[0]
            pd.append((x, c))
            assert torch.equal(W[i], b) and torch.equal(Z[i], z)
            assert torch.equal(P[i], x)
        assert torch.equal(pu, c)
        prev, zprev = [wp, w] + list(W), [w] + list(Z)
        for i in range(k):
            assert _normwise(W[i], prox_ref.prox_step_block(
                G[i:i + 1], R[i:i + 1], prev[i], prev[i + 1], scal,
                j0=5 + i, variant=variant)[0]) <= 1e-5
            assert _normwise(Z[i], prox_ref.prox_loop(
                G[i], R[i], zprev[i], scal, Q=3, variant=variant)) <= 1e-5
            rw, ru = prox_ref.pdhg_step(G[i], R[i], *pd[i], scal, sigma,
                                        variant=variant)
            assert _normwise(pd[i + 1][0], rw) <= 1e-5
            assert _dual_err(pd[i + 1][1], ru, rw, sigma) <= 1e-5


def test_prox_wrappers_take_d_past_the_one_cta_limit(cuda):
    """The one-CTA kernels keep the iterate in shared memory and stop at
    prox_loop_limits()[1]; the wrappers take the rows route above the
    threshold, so no prox op refuses a d that fits the card's memory."""
    _, max_d = prox_ops.prox_loop_limits()
    assert prox_ops.ROWS_ABOVE_D <= max_d
    d = 20_480
    assert d > max_d
    G, R, (v, _, _) = _rows_block(1, d, 1, cuda)
    scal = prox_scalars(*SCAL, device=cuda)
    kernels.reset_launch_counts()
    got = prox_ops.prox_step_cuda(G[0], R[0], v, scal)
    loop = prox_ops.prox_loop_cuda(G[0], R[0], v, scal, Q=2)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["prox_rows"] == 3
    assert _normwise(got, prox_ref.prox_step(G[0], R[0], v, scal)) <= 1e-5
    assert _normwise(loop, prox_ref.prox_loop(G[0], R[0], v, scal,
                                              Q=2)) <= 1e-5


#: the block prox kernels' card cases (label, k, d): the CA blocks of a
#: covtype-wide (d = 54: ring stages of 9 G_i) and a susy-wide (d = 18:
#: stages of 16) problem from gram_gather's own output, then random blocks:
#: k = 1 (G read from global memory), 2 (stages of one G_i) and 7, ragged
#: d = 61 (d^2 not a multiple of 4: global memory), d = 130 and 160
#: (stages of one G_i near the limit) and d = 300 (the rows route)
PROX_BLOCK_CASES = [("gram", 32, 54), ("gram", 32, 18), ("random", 1, 54),
                    ("random", 2, 54), ("random", 7, 54), ("random", 1, 18),
                    ("random", 7, 61), ("random", 32, 61),
                    ("random", 3, 130), ("random", 7, 160),
                    ("random", 7, 300), ("random", 1, 300)]


def _prox_block(label, k, d, device):
    if label == "gram":
        problem, _ = make_lasso_data(0, d=d, n=20_000, device=device)
        gen = torch.Generator(device=device).manual_seed(d)
        idx = torch.randint(0, problem.n, (k, 2_000), generator=gen,
                            device=device)
        G, R = problem.block_stats(idx)
    else:
        A = _randn((k, d, d), k + d, device)
        G = (A @ A.transpose(1, 2) / d).contiguous()
        R = _randn((k, d), k + d + 1, device)
    return G, R, _randn(d, d + 2, device), _randn(d, d + 3, device)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("label,k,d", PROX_BLOCK_CASES)
def test_prox_block_cuda_is_bitwise_its_k1_instance_run_k_times(
        cuda, label, k, d, variant):
    """A block launch against k launches of its k = 1 instance: for FISTA
    the stepwise route the solvers took before the block kernels
    (fista_update: the eager momentum ops, then prox_step) and the block
    kernel at k = 1, both bit for bit; for PNM prox_loop k times, bit for
    bit. Both within 1e-5 of their plain versions, normwise."""
    G, R, wp, w = _prox_block(label, k, d, cuda)
    scal = prox_scalars(*SCAL, device=cuda)
    j0 = 1 + 32 * VARIANTS.index(variant)
    W = prox_ops.prox_step_block_cuda(G, R, wp, w, scal, j0=j0,
                                      variant=variant)
    state, rows = ur.IterState(w_prev=wp, w=w, j=j0), []
    for i in range(k):
        state = ur.fista_update(G[i], R[i], state, scal, variant=variant)
        rows.append(state.w)
    a, b, ones = wp, w, []
    for i in range(k):
        a, b = b, prox_ops.prox_step_block_cuda(
            G[i:i + 1], R[i:i + 1], a, b, scal, j0=j0 + i,
            variant=variant)[0]
        ones.append(b)
    Z = prox_ops.prox_loop_block_cuda(G, R, w, scal, Q=5, variant=variant)
    z, zs = w, []
    for i in range(k):
        z = prox_ops.prox_loop_cuda(G[i], R[i], z, scal, Q=5, variant=variant)
        zs.append(z)
    torch.cuda.synchronize()
    assert W.shape == Z.shape == (k, d)
    assert torch.equal(W, torch.stack(rows))
    assert torch.equal(W, torch.stack(ones))
    assert torch.equal(Z, torch.stack(zs))
    assert _normwise(W, prox_ref.prox_step_block(
        G, R, wp, w, scal, j0=j0, variant=variant)) <= 1e-5
    assert _normwise(Z, prox_ref.prox_loop_block(
        G, R, w, scal, Q=5, variant=variant)) <= 1e-5


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("label,k,d", [c for c in PROX_BLOCK_CASES
                                       if c[2] <= prox_ops.ROWS_ABOVE_D])
def test_pdhg_block_cuda_is_bitwise_its_k1_instance_and_matches_plain(
        cuda, label, k, d, variant):
    """pdhg_block against k launches of its k = 1 instance, bit for bit (w
    and u), and each step within 1e-5 of the plain step (k calls of the
    stepwise pdhg_update's arithmetic) from the kernel's own previous
    iterate, normwise; at sigma = 1/t each step is ISTA's."""
    G, R, _, w = _prox_block(label, k, d, cuda)
    u = _randn(d, d + 4, cuda) * 0.01
    scal = prox_scalars(*SCAL, device=cuda)
    for sigma in (torch.tensor([0.5 / SCAL[0]], device=cuda),
                  torch.tensor([1.0 / SCAL[0]], device=cuda)):
        W, u_out = prox_ops.pdhg_block_cuda(G, R, w, u, scal, sigma,
                                            variant=variant)
        x, c, states = w, u, []
        for i in range(k):
            x1, c = prox_ops.pdhg_block_cuda(G[i:i + 1], R[i:i + 1], x, c,
                                             scal, sigma, variant=variant)
            x = x1[0]
            states.append((x, c))
        torch.cuda.synchronize()
        assert torch.equal(W, torch.stack([s[0] for s in states]))
        assert torch.equal(u_out, c)
        pw, pu = w, u
        for i in range(k):
            rw, ru = prox_ref.pdhg_step(G[i], R[i], pw, pu, scal, sigma,
                                        variant=variant)
            assert _normwise(W[i], rw) <= 1e-5
            assert _dual_err(states[i][1], ru, rw, sigma) <= 1e-5
            pw, pu = states[i]
    # sigma = 1/t, u0 = 0: each step is the ISTA step from the previous w
    sigma = torch.tensor([1.0 / SCAL[0]], device=cuda)
    W, _ = prox_ops.pdhg_block_cuda(G, R, w, torch.zeros_like(w), scal,
                                    sigma, variant=variant)
    prev = [w] + list(W)
    for i in range(k):
        assert _normwise(W[i], prox_ref.prox_step(
            G[i], R[i], prev[i], scal, variant=variant)) <= 1e-5


@pytest.mark.parametrize("k,r,m", [(2, 4096, 5), (1, 160, 200_000),
                                   (4, 160, 58_101)])
def test_gram_cuda_at_the_family_shapes(cuda, k, r, m):
    """gram at BCD's cross-Gram (r = k m_c = 160) and the dual SVM's G
    (r = n = 4,096, m = b d features): against the plain version."""
    Xs = _randn((k, r, m), k + r, cuda)
    got = gram_ops.gram_cuda(Xs)
    torch.cuda.synchronize()
    assert _normwise(got, gram_ref.gram(Xs)) <= GRAM_RTOL
    assert torch.equal(got[-1], gram_ops.gram_cuda(Xs[-1]))


def test_family_ca_matches_classical_through_the_kernels(cuda):
    """CA-PDHG is PDHG bit for bit (pdhg_block T/k and T times,
    gram_gather as often); CA-BCD is BCD to the JAX package's tolerance
    (gram T/k and T times); both near their plain solves."""
    from repro_torch.core import bcd, ca_bcd, ca_pdhg, pdhg
    problem, _ = make_lasso_data(0, d=54, n=20_000, device=cuda)
    cfg = SolverConfig(T=64, k=16, b=0.1, step_size=0.5)
    for cl, ca, op, atol in ((pdhg, ca_pdhg, "pdhg_block", 0.0),
                             (bcd, ca_bcd, "gram", 2e-5)):
        kernels.reset_launch_counts()
        w_cl, w_ca = cl(problem, cfg, 3), ca(problem, cfg, 3)
        launches = kernels.launch_counts()
        assert launches[op] == cfg.T + cfg.T // cfg.k
        if atol == 0.0:
            assert torch.equal(w_ca, w_cl)
            assert launches["gram_gather"] == cfg.T + cfg.T // cfg.k
        else:
            assert float((w_ca - w_cl).abs().max()) <= atol
        with registry.use("torch"):
            w_plain = cl(problem, cfg, 3)
        assert float((w_cl - w_plain).abs().max()) <= 1e-4


def test_distributed_world_one_nccl_is_bitwise_the_single_process(cuda):
    """An NCCL group of one in this process (an in-process store): the
    distributed CA-SFISTA and CA-BCD keep the single-process bits, with
    T/k all-reduces."""
    from repro_torch.core import ca_bcd
    from repro_torch.core.distributed import (CollectiveCount,
                                              make_distributed_solver)
    from repro_torch.launch import mesh
    problem, _ = make_lasso_data(0, d=54, n=20_000, device=cuda)
    cfg = SolverConfig(T=64, k=16, b=0.1, step_size=0.5)
    gen = torch.Generator(device=cuda).manual_seed(3)
    mesh.init("cuda", rank=0, world_size=1)
    try:
        for alg, single in (("ca_sfista", ca_sfista), ("ca_bcd", ca_bcd)):
            schedule = "coord" if alg == "ca_bcd" else "gram"
            idx = sstep.draws(problem, cfg, gen, None, schedule)
            count = CollectiveCount()
            w = make_distributed_solver(alg, cfg, problem.lam,
                                        counter=count)(
                problem.X, problem.y, torch.zeros(54, device=cuda), 0.5,
                idx=idx)
            assert count.all_reduces == cfg.T // cfg.k
            assert torch.equal(w, single(problem, cfg, idx=idx))
    finally:
        mesh.shutdown()


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
    block = "prox_step_block" if pair[0] is sfista else "prox_loop_block"
    assert launches["gram_gather"] == cfg.T + cfg.T // cfg.k
    assert launches["gram"] == 0
    assert launches[block] == cfg.T + cfg.T // cfg.k
    assert launches["prox_step"] + launches["prox_loop"] == 0
    assert all(b == "cuda" for _, b in registry.dispatch_counts())
    assert float((w_ca - w_cl).abs().max()) <= 5e-6
    assert torch.equal(w_ca, w_cl)
    with registry.use("torch"):
        w_plain = pair[0](problem, cfg, 3)
    assert float((w_cl - w_plain).abs().max()) <= 1e-4


# ------------------------------------------------------------- attention --
#: kernel vs plain version, normwise: float32 sums in another order stay
#: near 1e-7 of the largest output; a bf16 output may differ by one
#: rounding, 2^-7 of the largest magnitude
ATTN_RTOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


def _normal(shape, seed, device, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device=device, dtype=dtype)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,dtype", [
    (2, 16, 8, 1024, 1024, 128, True, torch.bfloat16),   # the forward's
    (2, 16, 8, 1000, 1000, 128, True, torch.bfloat16),   # ragged
    (2, 16, 8, 64, 1000, 128, True, torch.bfloat16),     # right-aligned
    (2, 16, 8, 37, 300, 128, False, torch.bfloat16),     # not causal
    (2, 16, 8, 257, 257, 128, True, torch.float32),
    (2, 4, 2, 12, 12, 16, True, torch.bfloat16),         # smoke config
    (1, 6, 2, 50, 70, 64, True, torch.float32),
    (1, 4, 4, 90, 40, 32, True, torch.float32),          # rows seeing no key
    # bf16 at every head dim: one partial CTA tile (Sq < 128), Sq > Skv
    # under causal, ragged Skv that is not a multiple of 64
    (1, 6, 2, 50, 70, 64, True, torch.bfloat16),
    (2, 16, 8, 512, 512, 64, True, torch.bfloat16),
    (1, 4, 4, 90, 40, 32, True, torch.bfloat16),
    (2, 4, 2, 300, 333, 16, False, torch.bfloat16),
    (1, 8, 4, 200, 130, 128, True, torch.bfloat16),
    (2, 32, 32, 300, 300, 80, True, torch.bfloat16),     # zamba2's D=80
    # the families: whisper's encoder (not causal), its cross-attention in
    # the forward and at decode's single query; qwen2-vl's group of 6
    (2, 16, 16, 1500, 1500, 64, False, torch.bfloat16),
    (2, 16, 16, 448, 1500, 64, False, torch.bfloat16),
    (2, 16, 16, 1, 1500, 64, False, torch.bfloat16),
    (2, 12, 2, 1536, 1536, 128, True, torch.bfloat16),
], ids=["fwd", "ragged", "right_aligned", "noncausal", "f32", "smoke",
        "d64", "sq_gt_skv", "d64_bf16", "d64_bf16_s512", "sq_gt_skv_bf16",
        "d16_ragged_bf16", "sq_gt_skv_d128_bf16", "d80_bf16",
        "whisper_encoder", "whisper_cross", "whisper_cross_decode",
        "qwen2_vl_group6"])
def test_flash_attention_cuda_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, D,
                                            causal, dtype):
    q = _normal((B, Sq, Hq, D), 1, cuda, dtype)
    k = _normal((B, Skv, Hkv, D), 2, cuda, dtype)
    v = _normal((B, Skv, Hkv, D), 3, cuda, dtype)
    got = fa_ops.flash_attention_cuda(q, k, v, causal=causal)
    want = fa_ref.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert _normwise(got.float(), want.float()) <= ATTN_RTOL[dtype]
    if Sq > Skv and causal:
        # query rows before the first key see nothing and give exactly 0
        assert float(got[:, :Sq - Skv].abs().max()) == 0.0


def test_flash_attention_cuda_takes_strided_views(cuda):
    """The model hands the kernel views of one projection; strides are
    read, nothing is copied."""
    qkv = _normal((2, 40, 16 + 2 * 8, 64), 4, cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :16], qkv[:, :, 16:24], qkv[:, :, 24:]
    got = fa_ops.flash_attention_cuda(q, k, v, causal=True)
    want = fa_ref.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True)
    torch.cuda.synchronize()
    assert _normwise(got.float(), want.float()) <= 8e-3


def test_flash_forward_cuda_is_deterministic_and_batch_free(cuda):
    """Two launches give the same bits in o and lse, and a row's output is
    the same bits alone as in its batch: no atomics, no split along the
    keys, one summation order per row."""
    q, k, v = (_normal((4, S, H, 128), seed, cuda, torch.bfloat16)
               for seed, S, H in ((1, 300, 16), (2, 300, 8), (3, 300, 8)))
    o1, lse1 = fa_ops.flash_attention_cuda(q, k, v, return_lse=True)
    o2, lse2 = fa_ops.flash_attention_cuda(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    for b in range(4):
        ob, lb = fa_ops.flash_attention_cuda(
            *(t[b:b + 1].contiguous() for t in (q, k, v)), return_lse=True)
        torch.cuda.synchronize()
        assert torch.equal(o1[b:b + 1], ob) and torch.equal(lse1[b:b + 1], lb)


#: share of the bf16 forward's outputs allowed to differ from the float32-p
#: plain version's (tests/test_torch_kernels.py holds the premise on the
#: CPU: the kernel's arithmetic ~0.2%, p rounded once ~38%)
P_FLIP_LIMIT = 0.02


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", [
    (2, 16, 8, 512, 512, 128, True),
    (2, 4, 2, 64, 333, 64, True),
    (1, 4, 2, 100, 300, 16, False),
], ids=["d128", "d64_right_aligned", "d16_noncausal"])
def test_flash_forward_cuda_keeps_p_at_float32_accuracy(cuda, B, Hq, Hkv,
                                                        Sq, Skv, D, causal):
    """The bf16 forward splits p into two bf16 halves for PV. Its outputs
    differ from the float32-p plain version's in under ``P_FLIP_LIMIT`` of
    the elements, where p rounded once to bf16 differs in more: the
    normwise 8e-3 limit cannot tell the two apart."""
    q = _normal((B, Sq, Hq, D), 1, cuda, torch.bfloat16)
    k = _normal((B, Skv, Hkv, D), 2, cuda, torch.bfloat16)
    v = _normal((B, Skv, Hkv, D), 3, cuda, torch.bfloat16)
    got = fa_ops.flash_attention_cuda(q, k, v, causal=causal)
    want = fa_ref.flash_attention(q, k, v, causal=causal)
    once = fa_ref.flash_attention_p_rounded(q, k, v, causal=causal)
    flips, flips_once = (float((x != want).float().mean())
                         for x in (got, once))
    assert flips <= P_FLIP_LIMIT < flips_once, (flips, flips_once)


def test_flash_kernels_need_16_byte_rows(cuda):
    """TMA reads the operands of all three bf16 flash kernels: a view 4-byte
    but not 16-byte aligned raises by name in each wrapper, and contiguous
    copies of the same values run."""
    buf = _normal((3 * 8 * 4 * 64 + 2,), 7, cuda, torch.bfloat16)
    q = buf[2:2 + 8 * 4 * 64].view(1, 8, 4, 64)          # base + 4 bytes
    k = buf[2 + 8 * 4 * 64:2 + 8 * 6 * 64].view(1, 8, 2, 64)
    v = buf[2 + 8 * 6 * 64:2 + 8 * 8 * 64].view(1, 8, 2, 64)
    assert q.data_ptr() % 16 == 4
    do = _normal((1, 8, 4, 64), 8, cuda, torch.bfloat16)
    o, lse = fa_ref.flash_attention_lse(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    with pytest.raises(ValueError, match="q rows must be 16-byte aligned"):
        fa_ops.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="q rows must be 16-byte aligned"):
        fa_ops.flash_dq_cuda(q, k, v, do, lse, delta)
    with pytest.raises(ValueError, match="q rows must be 16-byte aligned"):
        fa_ops.flash_dkv_cuda(q, k, v, do, lse, delta)
    q, k, v = (t.clone() for t in (q, k, v))         # fresh, aligned
    got = (fa_ops.flash_attention_cuda(q, k, v),
           fa_ops.flash_dq_cuda(q, k, v, do, lse, delta),
           *fa_ops.flash_dkv_cuda(q, k, v, do, lse, delta))
    want = (fa_ref.flash_attention(q, k, v),
            fa_ref.flash_dq(q, k, v, do, lse, delta),
            *fa_ref.flash_dkv(q, k, v, do, lse, delta))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _normwise(g.float(), w.float()) <= ATTN_RTOL[torch.bfloat16]


def _bwd_case(device, B, Hq, Hkv, Sq, Skv, D, dtype, seed=0):
    """q, k, v, do, and the plain forward's o, lse and delta."""
    q = _normal((B, Sq, Hq, D), seed + 1, device, dtype)
    k = _normal((B, Skv, Hkv, D), seed + 2, device, dtype)
    v = _normal((B, Skv, Hkv, D), seed + 3, device, dtype)
    do = _normal((B, Sq, Hq, D), seed + 4, device, dtype)
    return q, k, v, do


BWD_CASES = [
    (8, 16, 8, 1024, 1024, 128, True, torch.bfloat16),   # the training step's
    (2, 16, 8, 1000, 1000, 128, True, torch.bfloat16),   # ragged
    (2, 16, 8, 64, 1000, 128, True, torch.bfloat16),     # right-aligned
    (2, 16, 8, 37, 300, 128, False, torch.bfloat16),     # not causal
    (2, 16, 8, 257, 257, 128, True, torch.float32),
    (2, 4, 2, 12, 12, 16, True, torch.bfloat16),         # smoke config
    (1, 6, 2, 50, 70, 64, True, torch.float32),
    (1, 4, 4, 90, 40, 32, True, torch.float32),          # rows seeing no key
    # bf16 at the other head dims, and zamba2's D=80 (run padded to 128)
    (1, 6, 2, 50, 70, 64, True, torch.bfloat16),
    (1, 4, 4, 90, 40, 32, True, torch.bfloat16),
    (2, 32, 32, 200, 200, 80, True, torch.bfloat16),
    # the families where grads reach: whisper's encoder and cross-attention,
    # granite's train step (D=64), qwen2-vl's group of 6
    (2, 16, 16, 1500, 1500, 64, False, torch.bfloat16),
    (2, 16, 16, 448, 1500, 64, False, torch.bfloat16),
    (8, 16, 8, 1024, 1024, 64, True, torch.bfloat16),
    (2, 12, 2, 1536, 1536, 128, True, torch.bfloat16),
]
BWD_IDS = ["train", "ragged", "right_aligned", "noncausal", "f32", "smoke",
           "d64", "sq_gt_skv", "d64_bf16", "sq_gt_skv_d32_bf16", "d80_bf16",
           "whisper_encoder", "whisper_cross", "granite_train",
           "qwen2_vl_group6"]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,dtype", BWD_CASES,
                         ids=BWD_IDS)
def test_flash_lse_dq_dkv_cuda_match_plain(cuda, B, Hq, Hkv, Sq, Skv, D,
                                           causal, dtype):
    """The lse forward (o and lse), dq and dk/dv against their plain
    versions on the same inputs, normwise at the kernels' tolerance; a row
    that sees no key has lse -inf in both, output 0 and zero grads."""
    q, k, v, do = _bwd_case(cuda, B, Hq, Hkv, Sq, Skv, D, dtype)
    o, lse = fa_ops.flash_attention_cuda(q, k, v, causal=causal,
                                         return_lse=True)
    wo, wlse = fa_ref.flash_attention_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    assert _normwise(o.float(), wo.float()) <= ATTN_RTOL[dtype]
    seen = torch.isfinite(wlse)
    assert torch.equal(torch.isfinite(lse), seen)
    assert float((lse[seen] - wlse[seen]).abs().max()) <= 1e-4
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa_ops.flash_dq_cuda(q, k, v, do, lse, delta, causal=causal)
    dk, dv = fa_ops.flash_dkv_cuda(q, k, v, do, lse, delta, causal=causal)
    wdq = fa_ref.flash_dq(q, k, v, do, lse, delta, causal=causal)
    wdk, wdv = fa_ref.flash_dkv(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    for got, want in ((dq, wdq), (dk, wdk), (dv, wdv)):
        assert got.dtype == dtype and got.shape == want.shape
        assert bool(torch.isfinite(got).all())
        assert _normwise(got.float(), want.float()) <= ATTN_RTOL[dtype]
    if Sq > Skv and causal:
        blind = Sq - Skv
        assert float(o[:, :blind].abs().max()) == 0.0
        assert float(dq[:, :blind].abs().max()) == 0.0


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", [
    (2, 16, 8, 512, 512, 128, True),
    (2, 4, 2, 64, 333, 64, True),
    (1, 4, 2, 100, 300, 16, False),
], ids=["d128", "d64_right_aligned", "d16_noncausal"])
def test_flash_backward_cuda_keeps_p_and_ds_at_float32_accuracy(
        cuda, B, Hq, Hkv, Sq, Skv, D, causal):
    """The bf16 backward kernels split p and ds into two bf16 halves for
    their tensor-core products. Their dq, dk and dv differ from the float32
    plain versions' in under ``P_FLIP_LIMIT`` of the elements, where p and
    ds rounded once to bf16 differ in more (tests/test_torch_kernels.py
    holds the premise on the CPU)."""
    q, k, v, do = _bwd_case(cuda, B, Hq, Hkv, Sq, Skv, D, torch.bfloat16)
    o, lse = fa_ref.flash_attention_lse(q, k, v, causal=causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    got = (fa_ops.flash_dq_cuda(*args, causal=causal),
           *fa_ops.flash_dkv_cuda(*args, causal=causal))
    want = (fa_ref.flash_dq(*args, causal=causal),
            *fa_ref.flash_dkv(*args, causal=causal))
    once = (fa_ref.flash_dq_rounded(*args, causal=causal),
            *fa_ref.flash_dkv_rounded(*args, causal=causal))
    for name, g, w, r in zip(("dq", "dk", "dv"), got, want, once):
        flips, flips_once = (float((x != w).float().mean()) for x in (g, r))
        assert flips <= P_FLIP_LIMIT < flips_once, (name, flips, flips_once)


def test_flash_backward_cuda_is_deterministic_and_batch_free(cuda):
    """Two launches give the same bits, and a row's grads are the same
    bits alone as in its batch: both kernels sum in one fixed order."""
    q, k, v, do = _bwd_case(cuda, 3, 16, 8, 300, 300, 128, torch.bfloat16)
    o, lse = fa_ops.flash_attention_cuda(q, k, v, return_lse=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    dq1, (dk1, dv1) = fa_ops.flash_dq_cuda(*args), fa_ops.flash_dkv_cuda(*args)
    dq2, (dk2, dv2) = fa_ops.flash_dq_cuda(*args), fa_ops.flash_dkv_cuda(*args)
    one = [t[1:2].contiguous() for t in args]
    dq3, (dk3, dv3) = fa_ops.flash_dq_cuda(*one), fa_ops.flash_dkv_cuda(*one)
    torch.cuda.synchronize()
    for a, b, c in ((dq1, dq2, dq3), (dk1, dk2, dk3), (dv1, dv2, dv3)):
        assert torch.equal(a, b)
        assert torch.equal(a[1:2], c)


def test_flash_backward_cuda_takes_strided_views(cuda):
    """q, k, v as views of one projection and do as a view: strides are
    read, nothing is copied."""
    qkv = _normal((2, 40, 16 + 2 * 8, 64), 4, cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :16], qkv[:, :, 16:24], qkv[:, :, 24:]
    do = _normal((2, 40, 32, 64), 5, cuda, torch.bfloat16)[:, :, ::2]
    o, lse = fa_ops.flash_attention_cuda(q, k, v, return_lse=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    c = [t.contiguous() for t in (q, k, v, do)]
    got = (fa_ops.flash_dq_cuda(q, k, v, do, lse, delta),
           *fa_ops.flash_dkv_cuda(q, k, v, do, lse, delta))
    want = (fa_ref.flash_dq(*c, lse, delta), *fa_ref.flash_dkv(*c, lse,
                                                               delta))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _normwise(g.float(), w.float()) <= 8e-3


def test_attention_autograd_through_the_kernels(cuda):
    """The model's attention under autograd launches the lse forward, dq
    and dk/dv once each, and its grads match the plain Function's."""
    q, k, v, do = _bwd_case(cuda, 2, 8, 4, 200, 200, 64, torch.float32)
    grads = {}
    for backend in ("cuda", "torch"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        kernels.reset_launch_counts()
        with registry.use(backend):
            o = fa_ops.flash_attention(*leaves, causal=True)
        o.backward(do)
        grads[backend] = [t.grad for t in leaves]
        launches = kernels.launch_counts()
        n = 1 if backend == "cuda" else 0
        assert (launches["flash_attention"], launches["flash_dq"],
                launches["flash_dkv"]) == (n, n, n)
    for a, b in zip(grads["cuda"], grads["torch"]):
        assert _normwise(a, b) <= 1e-5


def test_backward_wrappers_reject_bad_operands(cuda):
    q, k, v, do = _bwd_case(cuda, 1, 4, 2, 8, 8, 64, torch.bfloat16)
    lse = torch.zeros(1, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="lse must be contiguous"):
        fa_ops.flash_dq_cuda(q, k, v, do, lse[:, :2], lse)
    with pytest.raises(ValueError, match="delta"):
        fa_ops.flash_dkv_cuda(q, k, v, do, lse, lse.bfloat16())
    with pytest.raises(ValueError, match="share a dtype"):
        fa_ops.flash_dq_cuda(q, k, v, do.float(), lse, lse)
    with pytest.raises(ValueError, match="do"):
        fa_ops.flash_dkv_cuda(q, k, v, do[:, :4], lse, lse)


def _paged_case(device, *, B, Hq, Hkv, D, P, npages, kv, seed=0,
                valid=None):
    """A page pool with ragged valid lengths (1..npages*P unless ``valid``
    gives them), each row's pages drawn without repeats, and table entries
    past valid set to 0."""
    rng = np.random.default_rng(seed)
    num_pages = 1 + B * npages
    if valid is None:
        valid = np.linspace(1, npages * P, B)
    valid = np.asarray(valid).astype(np.int32)
    perm = rng.permutation(np.arange(1, num_pages)).reshape(B, npages)
    used = -(-valid // P)
    table = np.where(np.arange(npages)[None] < used[:, None], perm, 0)
    qdt = torch.float32 if kv == "f32" else torch.bfloat16
    q = _normal((B, 1, Hq, D), seed + 1, device, qdt)
    shape = (num_pages, P, Hkv, D)
    if kv == "int8":
        k = torch.from_numpy(rng.integers(-127, 128, shape).astype(
            np.int8)).to(device)
        v = torch.from_numpy(rng.integers(-127, 128, shape).astype(
            np.int8)).to(device)
        ks = torch.from_numpy(rng.uniform(0.001, 0.02, shape[:3]).astype(
            np.float32)).to(device)
        vs = torch.from_numpy(rng.uniform(0.001, 0.02, shape[:3]).astype(
            np.float32)).to(device)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        dt = torch.float32 if kv == "f32" else torch.bfloat16
        k = _normal(shape, seed + 2, device, dt)
        v = _normal(shape, seed + 3, device, dt)
        scales = {}
    t = torch.from_numpy(table.astype(np.int32)).to(device)
    n = torch.from_numpy(valid).to(device)
    return (q, k, v, t, n), scales


@pytest.mark.parametrize("kv", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("P,npages,D,Hq,Hkv", [
    (16, 64, 128, 16, 8),        # the engine's shape
    (5, 7, 128, 16, 8),          # odd page size
    (5, 4, 16, 4, 2),            # smoke config
    (3, 9, 64, 8, 1),            # group of 8
    (16, 8, 80, 32, 32),         # zamba2's heads, the D=80 instance
])
def test_paged_decode_cuda_matches_plain(cuda, kv, P, npages, D, Hq, Hkv):
    args, scales = _paged_case(cuda, B=8, Hq=Hq, Hkv=Hkv, D=D, P=P,
                               npages=npages, kv=kv)
    got = fa_ops.paged_decode_cuda(*args, **scales)
    want = fa_ref.paged_decode(*args, **scales)
    torch.cuda.synchronize()
    assert got.dtype == args[0].dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert _normwise(got.float(), want.float()) <= ATTN_RTOL[got.dtype]


def _row_slices(args, scales, m):
    """Each of m ranks' rows of every page of the case's pools: (k, v,
    scales, row_base) a rank, contiguous."""
    P = args[1].shape[1]
    R = P // m
    out = []
    for r in range(m):
        cut = slice(r * R, (r + 1) * R)
        out.append((args[1][:, cut].contiguous(),
                    args[2][:, cut].contiguous(),
                    {n: t[:, cut].contiguous() for n, t in scales.items()},
                    r * R))
    return out


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("D,Hq,Hkv", [(128, 16, 8), (64, 16, 8),
                                      (80, 32, 32)])
def test_paged_decode_cuda_row_map_and_lse(cuda, kv, D, Hq, Hkv, m):
    """The row-map and lse instance: each of m ranks' rows of every page
    (local row j of entry i at position i * P + rank P/m + j) against
    ``ref.paged_decode`` on the same slice, o normwise and the lse within
    1e-5 (-inf where the rank holds no valid row); the ranks merged
    (``ref.merge_partials``) against the unsplit kernel; with base 0 and
    the page size as stride, no lse, bitwise the default call. Lengths up
    to 1,024 cross the kernel's 128-position chunks (its ticket merge)."""
    args, scales = _paged_case(cuda, B=8, Hq=Hq, Hkv=Hkv, D=D, P=16,
                               npages=64, kv=kv,
                               valid=[1, 3, 9, 17, 130, 500, 777, 1024])
    q, _, _, t, n = args
    whole = fa_ops.paged_decode_cuda(*args, **scales)
    same = fa_ops.paged_decode_cuda(*args, **scales, row_base=0,
                                    row_stride=16)
    assert torch.equal(whole, same)
    outs, lses = [], []
    for k, v, sc, base in _row_slices(args, scales, m):
        o, lse = fa_ops.paged_decode_cuda(q, k, v, t, n, **sc,
                                          row_base=base, row_stride=16,
                                          return_lse=True)
        wo, wl = fa_ref.paged_decode(q, k, v, t, n, **sc, row_base=base,
                                     row_stride=16, return_lse=True)
        torch.cuda.synchronize()
        assert _normwise(o.float(), wo.float()) <= ATTN_RTOL[o.dtype]
        assert torch.equal(torch.isinf(lse), torch.isinf(wl))
        fin = torch.isfinite(wl)
        assert float((lse[fin] - wl[fin]).abs().max()) <= 1e-5 * max(
            1.0, float(wl[fin].abs().max()))
        outs.append(o)
        lses.append(lse)
    merged = fa_ref.merge_partials(torch.stack(outs), torch.stack(lses))
    assert _normwise(merged.float(), whole.float()) <= ATTN_RTOL[
        merged.dtype]


def test_paged_decode_cuda_never_reads_past_valid(cuda):
    """Pool rows at and past valid, page 0 among them, weigh exactly 0:
    filling them with NaN changes no output bit."""
    args, _ = _paged_case(cuda, B=4, Hq=4, Hkv=2, D=64, P=5, npages=6,
                          kv="bf16")
    q, k, v, t, n = args
    before = fa_ops.paged_decode_cuda(q, k, v, t, n)
    k2, v2 = k.clone(), v.clone()
    k2[0], v2[0] = float("nan"), float("nan")
    for b, nb in enumerate(n.tolist()):
        pg, row = t[b, (nb - 1) // 5].item(), (nb - 1) % 5
        k2[pg, row + 1:], v2[pg, row + 1:] = float("nan"), float("nan")
    after = fa_ops.paged_decode_cuda(q, k2, v2, t, n)
    torch.cuda.synchronize()
    assert torch.equal(before, after)


def _paged_plain_check(args, scales):
    got = fa_ops.paged_decode_cuda(*args, **scales)
    want = fa_ref.paged_decode(*args, **scales)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _normwise(got.float(), want.float()) <= ATTN_RTOL[got.dtype]
    return got


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_decode_cuda_chunk_edges(cuda, kv):
    """Rows of 0, 1, 127, 128, 129 and 256 valid positions: no chunk, one
    chunk (written by its own CTA), one full chunk, and two (merged by the
    last ticket). A row with none gives exactly 0."""
    args, scales = _paged_case(cuda, B=6, Hq=16, Hkv=8, D=128, P=16,
                               npages=16, kv=kv,
                               valid=[0, 1, 127, 128, 129, 256])
    got = _paged_plain_check(args, scales)
    assert bool((got[0] == 0).all())


@pytest.mark.parametrize("kv", ["bf16", "int8", "f32"])
def test_paged_decode_cuda_more_than_8_chunks(cuda, kv):
    """A table reaching 1,280 positions (80 pages of 16, 10 chunks): the
    ticket merge takes more than 8 partials."""
    args, scales = _paged_case(cuda, B=4, Hq=8, Hkv=2, D=64, P=16,
                               npages=80, kv=kv,
                               valid=[1280, 1153, 1025, 700])
    _paged_plain_check(args, scales)


def test_paged_decode_cuda_two_launches_bit_equal(cuda):
    args, scales = _paged_case(cuda, B=8, Hq=16, Hkv=8, D=128, P=16,
                               npages=64, kv="bf16", seed=4)
    a = fa_ops.paged_decode_cuda(*args, **scales)
    b = fa_ops.paged_decode_cuda(*args, **scales)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_decode_cuda_row_bits_do_not_depend_on_batch(cuda, kv):
    """Each row alone (a batch of 1) gives its bits in the batch of 8:
    the chunk is a constant and the merge order fixed."""
    (q, k, v, t, n), scales = _paged_case(cuda, B=8, Hq=16, Hkv=8, D=128,
                                          P=16, npages=64, kv=kv, seed=5)
    batch = fa_ops.paged_decode_cuda(q, k, v, t, n, **scales)
    for r in range(8):
        one = fa_ops.paged_decode_cuda(
            q[r:r + 1].contiguous(), k, v, t[r:r + 1].contiguous(),
            n[r:r + 1].contiguous(), **scales)
        torch.cuda.synchronize()
        assert torch.equal(one[0], batch[r]), r


def test_paged_decode_cuda_tickets_reset_between_calls(cuda):
    """A call at one shape, then calls at others on the same stream: each
    launch leaves its tickets at 0, or the next would merge early or never
    (the outputs would be wrong or unwritten)."""
    for B, Hq, Hkv, D, P, npages, seed in ((8, 16, 8, 128, 16, 64, 0),
                                           (3, 8, 4, 64, 5, 60, 1),
                                           (8, 16, 8, 128, 16, 64, 2),
                                           (16, 4, 2, 32, 16, 20, 3)):
        args, scales = _paged_case(cuda, B=B, Hq=Hq, Hkv=Hkv, D=D, P=P,
                                   npages=npages, kv="bf16", seed=seed)
        _paged_plain_check(args, scales)
    q = args[0]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _, tickets = fa_ops._SCRATCH[(q.device.index, stream)]
    torch.cuda.synchronize()
    assert int(tickets.abs().sum()) == 0


def test_paged_decode_cuda_rejects_misaligned_pools_and_large_pages(cuda):
    (q, kp, vp, t, n), _ = _paged_case(cuda, B=2, Hq=4, Hkv=2, D=64, P=5,
                                       npages=3, kv="bf16")
    flat = torch.empty(kp.numel() + 1, dtype=kp.dtype, device=cuda)
    shifted = flat[1:].view(kp.shape)            # base 2 bytes off
    shifted.copy_(kp)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa_ops.paged_decode_cuda(q, shifted, vp, t, n)
    (q, kp, vp, t, n), _ = _paged_case(cuda, B=2, Hq=4, Hkv=2, D=16, P=257,
                                       npages=1, kv="bf16")
    with pytest.raises(ValueError, match="page size 257"):
        fa_ops.paged_decode_cuda(q, kp, vp, t, n)


@pytest.mark.parametrize("kv", ["bf16", "f32"])
def test_paged_decode_cuda_largest_pages(cuda, kv):
    """Page size 256, the largest taken: the kernel loads a page in boxes
    of 64 rows, so float32 pages fit its shared memory too."""
    args, scales = _paged_case(cuda, B=3, Hq=4, Hkv=2, D=128, P=256,
                               npages=3, kv=kv)
    _paged_plain_check(args, scales)


def test_attention_wrappers_reject_cpu_and_bad_operands(cuda):
    q = _normal((1, 8, 4, 64), 0, cuda, torch.bfloat16)
    k = _normal((1, 8, 2, 64), 1, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        fa_ops.flash_attention_cuda(q.cpu(), k.cpu(), k.cpu())
    with pytest.raises(ValueError, match="dtype|must be one of"):
        fa_ops.flash_attention_cuda(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="share a dtype"):
        fa_ops.flash_attention_cuda(q, k.float(), k)
    k3 = _normal((1, 8, 3, 64), 2, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="GQA"):
        fa_ops.flash_attention_cuda(q, k3, k3)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention_cuda(q[..., :44].contiguous(),
                                    k[..., :44].contiguous(),
                                    k[..., :44].contiguous())
    (q1, kp, vp, t, n), _ = _paged_case(cuda, B=2, Hq=4, Hkv=2, D=64, P=5,
                                        npages=3, kv="bf16")
    with pytest.raises(ValueError, match="CUDA device"):
        fa_ops.paged_decode_cuda(q1.cpu(), kp, vp, t, n)
    with pytest.raises(ValueError, match="int32"):
        fa_ops.paged_decode_cuda(q1, kp, vp, t.long(), n)
    with pytest.raises(ValueError, match="k_scale"):
        fa_ops.paged_decode_cuda(q1, kp.to(torch.int8), vp.to(torch.int8),
                                 t, n)
    with pytest.raises(ValueError, match="single query"):
        fa_ops.paged_decode_cuda(q1.expand(2, 2, 4, 64).contiguous(), kp,
                                 vp, t, n)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        with registry.use("cuda"):
            registry.dispatch("paged_attention", q1.cpu(), kp.cpu(),
                              vp.cpu(), t.cpu(), n.cpu())


# ------------------------------------------------ model and engine (smoke) --
CFG = smoke_config(get_arch("internlm2-1.8b"))
PROMPTS = [[7], [3, 11, 5], [9, 2], [4, 4, 4, 8], [13], [1, 2, 3, 4, 5, 6]]


def _params(device):
    gen = torch.Generator(device=device).manual_seed(0)
    return init_params(CFG, gen, dtype=torch.bfloat16, device=device)


def test_teacher_forced_paged_decode_matches_forward(cuda):
    """forward (flash_attention kernel) and decode_step one token at a
    time through a bf16 paged cache (paged_decode kernel) agree within the
    JAX package's own tolerance for this check (tests/test_models.py)."""
    params = _params(cuda)
    B, S = 2, 24
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, CFG.vocab, (B, S)).astype(np.int32)).to(cuda)
    kernels.reset_launch_counts()
    logits, _ = forward(params, CFG, {"tokens": toks})
    assert kernels.launch_counts()["flash_attention"] == CFG.n_layers
    pool = PagedCachePool(CFG, B, S, page_size=5, device=cuda)
    for b in range(B):
        pool.reserve(pool.allocate(f"r{b}"), S)
    cache = pool.make_cache()
    table = torch.from_numpy(pool.tables).to(cuda)
    outs = []
    for t in range(S):
        pos = torch.full((B,), t, dtype=torch.int32, device=cuda)
        lg, cache = decode_step(params, CFG, cache, toks[:, t:t + 1],
                                positions=pos, page_table=table)
        outs.append(lg[:, 0])
    assert kernels.launch_counts()["paged_decode"] == S * CFG.n_layers
    torch.testing.assert_close(torch.stack(outs, 1).float(), logits.float(),
                               atol=0.05, rtol=0.05)


@pytest.mark.parametrize("mode", [dict(), dict(page_size=5),
                                  dict(page_size=5, kv_dtype="int8")],
                         ids=["slot", "paged", "int8"])
def test_engine_streams_do_not_depend_on_k(cuda, mode):
    """Token streams at k=4 equal those at k=1 bit for bit, the k-step
    block makes no hidden host sync (sync_debug raises on one), and the
    engine launches paged_decode once per layer per step: the paged pool
    through its table, the slot pool through its in-place page view."""
    params = _params(cuda)
    streams = {}
    for k in (1, 4):
        eng = Engine(params, CFG, num_slots=3, max_len=32, k=k,
                     device=cuda, sync_debug=True, **mode)
        kernels.reset_launch_counts()
        out = eng.run([Request(id=f"r{i}", prompt=p, max_new_tokens=6)
                       for i, p in enumerate(PROMPTS)])
        launches = kernels.launch_counts()
        s = eng.stats
        assert s.retired == len(PROMPTS) and s.steps == s.syncs * k
        assert all(len(r.tokens) == 6 for r in out)
        assert launches["paged_decode"] == s.steps * CFG.n_layers
        assert launches["flash_attention"] == 0
        streams[k] = {r.id: r.tokens for r in out}
    assert streams[1] == streams[4]


def test_train_step_through_the_backward_kernels(cuda):
    """Smoke config, CA k=2 with remat: every layer's attention runs the lse
    forward twice (forward, recompute) and dq, dk/dv once per microbatch;
    the step's loss and grad norm match the plain versions' step."""
    metrics = {}
    for backend in ("cuda", "torch"):
        state = init_train_state(CFG, torch.Generator(
            device=cuda).manual_seed(0), device=cuda)
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, CFG.vocab, (8, 17),
                                             dtype=np.int32)).to(cuda)
        batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
        with registry.use(backend):
            step = make_train_step(CFG, ca_k=2, remat=True, warmup=1)
        kernels.reset_launch_counts()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        n = CFG.n_layers * 2 if backend == "cuda" else 0
        assert launches["flash_dq"] == launches["flash_dkv"] == n
        assert launches["flash_attention"] == 2 * n
        metrics[backend] = {k: float(v) for k, v in m.items()}
    assert np.isfinite(metrics["cuda"]["loss"])
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(metrics["cuda"][name],
                                   metrics["torch"][name], rtol=5e-3)


# ------------------------------------------------------------------- ssd --
#: SSD kernels vs plain, normwise: float32 outputs 1e-5 (the kernels'
#: float32 sums against the plain versions' float64 sums), y in bf16 8e-3
#: (one rounding at the top of the range), da 1e-4 (its reverse cumsum
#: subtracts large terms)
SSD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
SSD_DA_RTOL = 1e-4


def _ssd_case(device, Bt, S, H, P, N, dtype, seed=0, decay="test",
              bc=torch.float32):
    """x as a strided view of a wider projection (as the model hands it),
    dt, A float32, B and C float32 or (``bc`` bf16) views of the same
    projection, as mamba2's conv output hands them; dy and dh for the
    backward. ``decay="model"`` takes mamba2's A = -(1..16) with dt up to
    ~2, so that exp overflows above the diagonal."""
    rng = np.random.default_rng(seed)
    wide = torch.from_numpy(rng.standard_normal(
        (Bt, S, H * P + 2 * N)).astype(np.float32)).to(device, dtype)
    x = wide[..., :H * P].reshape(Bt, S, H, P)
    dt = np.logaddexp(rng.standard_normal((Bt, S, H)), 0.0)
    if decay == "model":
        A = -np.linspace(1.0, 16.0, H)
    else:
        dt, A = dt * 0.5, -np.exp(rng.standard_normal(H) * 0.5)
    f32 = [torch.from_numpy(np.asarray(a, np.float32)).to(device)
           for a in (dt, A, rng.standard_normal((Bt, S, N)),
                     rng.standard_normal((Bt, S, N)),
                     rng.standard_normal((Bt, H, P, N)))]
    dy = _normal((Bt, S, H, P), seed + 1, device, dtype)
    dt, A, B, C, dh = f32
    if bc == torch.bfloat16:
        B, C = wide[..., H * P:H * P + N], wide[..., H * P + N:]
    return (x, dt, A, B, C), dy, dh


BF16 = torch.bfloat16
SSD_CASES = [  # (Bt, S, H, P, N, chunk, x dtype, decay, B/C dtype)
    (8, 1024, 48, 64, 128, 64, BF16, "test", torch.float32),  # the train step
    (2, 512, 48, 64, 128, 64, BF16, "model", torch.float32),  # the forward
    (2, 1000, 48, 64, 128, 64, BF16, "test", torch.float32),  # ragged
    (2, 37, 48, 64, 128, 64, BF16, "test", torch.float32),    # S < chunk
    (2, 512, 48, 64, 128, 32, BF16, "test", torch.float32),   # chunk 32
    (2, 512, 48, 64, 128, 64, torch.float32, "model", torch.float32),
    (2, 70, 8, 16, 16, 64, torch.float32, "test", torch.float32),  # smoke
    (2, 70, 8, 16, 16, 32, BF16, "model", torch.float32),
    (2, 512, 80, 64, 64, 64, BF16, "model", torch.float32),   # zamba2's heads
    (2, 200, 8, 64, 64, 32, torch.float32, "test", torch.float32),
    # B and C in bf16, as the model hands them: the tensor-core bodies
    (8, 1024, 48, 64, 128, 64, BF16, "test", BF16),
    (2, 512, 48, 64, 128, 64, BF16, "model", BF16),
    (2, 1000, 48, 64, 128, 64, BF16, "test", BF16),
    (2, 37, 48, 64, 128, 64, BF16, "test", BF16),
    (2, 512, 48, 64, 128, 32, BF16, "test", BF16),
    (2, 70, 8, 16, 16, 32, BF16, "model", BF16),
    (2, 512, 80, 64, 64, 64, BF16, "model", BF16)]
SSD_IDS = ["train", "forward", "ragged", "short", "chunk32", "f32", "smoke",
           "smoke32", "zamba2", "zamba2_chunk32_f32", "train_bf16bc",
           "forward_bf16bc", "ragged_bf16bc", "short_bf16bc",
           "chunk32_bf16bc", "smoke32_bf16bc", "zamba2_bf16bc"]


def _flips(got, want):
    return float((got != want).float().mean())


@pytest.mark.parametrize("Bt,S,H,P,N,chunk,dtype,decay,bc", SSD_CASES,
                         ids=SSD_IDS)
def test_ssd_cuda_kernels_match_plain(cuda, Bt, S, H, P, N, chunk, dtype,
                                      decay, bc):
    """ssd (y, h_final, the per-chunk states) and ssd_bwd (dxdt, da, dB,
    dC per head) against their plain versions on the same operands, by
    the body the operand types choose (the tensor cores when x, B and C are
    all bf16); bf16 y within the flip share the plain version rounded once
    exceeds (``P_FLIP_LIMIT``: the tensor-core bodies carry M' and h as two
    bf16 terms; tests/test_torch_ssd.py::test_bf16_terms_meet_the_limits);
    two launches of each give the same bits."""
    args, dy, dh = _ssd_case(cuda, Bt, S, H, P, N, dtype, decay=decay, bc=bc)
    kernels.reset_launch_counts()
    y, h, states = ssd_ops.ssd_cuda(*args, chunk=chunk, return_states=True)
    wy, wh, ws = ssd_ref.ssd_chunked(*args, chunk=chunk, return_states=True)
    torch.cuda.synchronize()
    tc = dtype == BF16 and bc == BF16
    assert (ssd_ops.ssd_cuda.launches_bf16,
            ssd_ops.ssd_cuda.launches_f32) == ((1, 0) if tc else (0, 1))
    assert y.dtype == dtype and torch.isfinite(y.float()).all()
    assert _normwise(y.float(), wy.float()) <= SSD_RTOL[dtype]
    if dtype == BF16:
        once = ssd_ref.ssd_chunked_rounded(*args, chunk=chunk)
        assert _flips(y, wy) <= P_FLIP_LIMIT < _flips(once, wy)
    assert _normwise(h, wh) <= SSD_RTOL[torch.float32]
    if S > chunk:
        assert _normwise(states, ws) <= SSD_RTOL[torch.float32]
    got = ssd_ops.ssd_bwd_cuda(*args, dy, states, dh, chunk=chunk)
    want = ssd_ref.ssd_bwd(*args, dy, states, dh, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_bwd_cuda.launches_bf16 == int(tc)
    for name, g, w in zip(("dxdt", "da", "dB", "dC"), got, want):
        assert torch.isfinite(g).all(), name
        rtol = SSD_DA_RTOL if name == "da" else SSD_RTOL[torch.float32]
        assert _normwise(g, w) <= rtol, name
    again = ssd_ops.ssd_cuda(*args, chunk=chunk, return_states=True)
    assert all(torch.equal(a, b) for a, b in zip((y, h, states), again))
    again = ssd_ops.ssd_bwd_cuda(*args, dy, states, dh, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_ssd_cuda_rows_do_not_depend_on_the_batch(cuda):
    """A batch row's outputs have the same bits alone and in its batch, and
    a null dh_final is zeros."""
    args, dy, dh = _ssd_case(cuda, 3, 200, 4, 64, 128, torch.bfloat16)
    y, h, st = ssd_ops.ssd_cuda(*args, return_states=True)
    bwd = ssd_ops.ssd_bwd_cuda(*args, dy, st, None)
    zero = ssd_ops.ssd_bwd_cuda(*args, dy, st, torch.zeros_like(dh))
    assert all(torch.equal(a, b) for a, b in zip(bwd, zero))
    one = [a[1:2] for a in args[:2]] + [args[2]] + [a[1:2] for a in args[3:]]
    y1, h1, st1 = ssd_ops.ssd_cuda(*one, return_states=True)
    assert torch.equal(y1, y[1:2]) and torch.equal(h1, h[1:2])
    b1 = ssd_ops.ssd_bwd_cuda(*one, dy[1:2], st1, None)
    assert all(torch.equal(a, b[1:2]) for a, b in zip(b1, bwd))


def test_ssd_tensor_core_rows_do_not_depend_on_the_batch(cuda):
    """The tensor-core bodies: a batch row's outputs have the same bits
    alone and in its batch, and a null dh_final is zeros."""
    args, dy, dh = _ssd_case(cuda, 3, 200, 4, 64, 128, BF16, bc=BF16)
    y, h, st = ssd_ops.ssd_cuda(*args, return_states=True)
    bwd = ssd_ops.ssd_bwd_cuda(*args, dy, st, None)
    zero = ssd_ops.ssd_bwd_cuda(*args, dy, st, torch.zeros_like(dh))
    assert all(torch.equal(a, b) for a, b in zip(bwd, zero))
    one = [a[1:2] for a in args[:2]] + [args[2]] + [a[1:2] for a in args[3:]]
    y1, h1, st1 = ssd_ops.ssd_cuda(*one, return_states=True)
    assert torch.equal(y1, y[1:2]) and torch.equal(h1, h[1:2])
    b1 = ssd_ops.ssd_bwd_cuda(*one, dy[1:2], st1, None)
    assert all(torch.equal(a, b[1:2]) for a, b in zip(b1, bwd))


def test_ssd_wrappers_reject_bad_operands(cuda):
    args, dy, dh = _ssd_case(cuda, 1, 64, 2, 64, 128, torch.float32)
    x, dt, A, B, C = args
    with pytest.raises(ValueError, match="zero state"):
        ssd_ops.ssd_cuda(*args, h0=dh)
    with pytest.raises(ValueError, match="not among the built"):
        ssd_ops.ssd_cuda(*args, chunk=128)
    with pytest.raises(ValueError, match="float32"):
        ssd_ops.ssd_cuda(x, dt, A, B.bfloat16(), C.bfloat16())
    with pytest.raises(ValueError, match="share a dtype"):
        ssd_ops.ssd_cuda(x.bfloat16(), dt, A, B.bfloat16(), C)
    odd = torch.zeros(1, 64, 2 * 64 + 3, dtype=BF16, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd_ops.ssd_cuda(odd[..., :128].reshape(1, 64, 2, 64), dt, A,
                         B.bfloat16(), C.bfloat16())
    with pytest.raises(ValueError, match="unit stride"):
        ssd_ops.ssd_cuda(x.transpose(2, 3).contiguous().transpose(2, 3),
                         dt, A, B, C)
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_ops.ssd_cuda(x.cpu(), dt, A, B, C)
    _, _, st = ssd_ops.ssd_cuda(*args, return_states=True)
    with pytest.raises(ValueError, match="states"):
        ssd_ops.ssd_bwd_cuda(*args, dy, st[:, :, :0], None)
    with registry.use("cuda"):
        with pytest.raises(RuntimeError, match="zero state"):
            registry.select("ssd", *args, chunk=64, h0=dh)


def test_ssd_autograd_through_the_kernels(cuda):
    """``ssd`` under autograd launches the forward, the states sweep and
    the reverse scan, and its grads equal the plain backend's to 1e-5
    normwise (bf16 dx 8e-3)."""
    args, _, _ = _ssd_case(cuda, 2, 300, 4, 64, 128, torch.bfloat16)
    grads = {}
    for backend in ("cuda", "torch"):
        leaves_ = [a.detach().clone().requires_grad_() for a in args]
        kernels.reset_launch_counts()
        with registry.use(backend):
            y, h = ssd_ops.ssd(*leaves_)
            loss = (y.float() ** 2).sum() + (h ** 2).sum()
            grads[backend] = torch.autograd.grad(loss, leaves_)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        want = (2, 1) if backend == "cuda" else (0, 0)
        assert (launches["ssd"], launches["ssd_bwd"]) == want
    for i, (g, w) in enumerate(zip(grads["cuda"], grads["torch"])):
        tol = SSD_RTOL[g.dtype] if g.dtype == torch.bfloat16 else 1e-4
        assert g.dtype == args[i].dtype and _normwise(g.float(),
                                                      w.float()) <= tol, i


def test_ssd_autograd_through_the_tensor_core_kernels(cuda):
    """``ssd`` under autograd with bf16 x, B and C, as the model calls it:
    the forward, the states sweep and the reverse scan run the tensor-core
    bodies, and the grads equal the plain backend's (bf16 grads 8e-3
    normwise, float32 1e-4)."""
    args, _, _ = _ssd_case(cuda, 2, 300, 4, 64, 128, BF16, bc=BF16)
    grads = {}
    for backend in ("cuda", "torch"):
        leaves_ = [a.detach().clone().requires_grad_() for a in args]
        kernels.reset_launch_counts()
        with registry.use(backend):
            y, h = ssd_ops.ssd(*leaves_)
            loss = (y.float() ** 2).sum() + (h ** 2).sum()
            grads[backend] = torch.autograd.grad(loss, leaves_)
        torch.cuda.synchronize()
        bodies = kernels.body_launch_counts()
        want = (2, 1) if backend == "cuda" else (0, 0)
        assert (bodies["ssd.launches_bf16"],
                bodies["ssd_bwd.launches_bf16"]) == want
    for i, (g, w) in enumerate(zip(grads["cuda"], grads["torch"])):
        tol = SSD_RTOL[g.dtype] if g.dtype == BF16 else 1e-4
        assert g.dtype == args[i].dtype and _normwise(g.float(),
                                                      w.float()) <= tol, i


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "whisper-medium"])
def test_family_forward_on_the_card_matches_the_cpu(cuda, name):
    """granite's MoE and whisper's encoder-decoder at the smoke config, the
    same bf16 weights and inputs: the forward on the card (flash_attention
    at every attention, whisper's non-causal encoder and its cross-attention
    among them) against the same model on the CPU (the plain versions), at
    the JAX package's logits tolerance."""
    cfg = smoke_config(get_arch(name))
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    batch = dict(tokens=torch.from_numpy(rng.integers(
        0, cfg.vocab, (2, 24)).astype(np.int32)))
    if cfg.family == "audio":
        batch["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, 40, cfg.d_model)).astype(np.float32))
    want, want_aux = forward(params, cfg, batch)
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    kernels.reset_launch_counts()
    got, aux = forward(tree_map(lambda t: t.to(cuda), params), cfg, on_card)
    torch.cuda.synchronize()
    n_attn = (cfg.n_enc_layers + 2 * cfg.n_layers
              if cfg.family == "audio" else cfg.n_layers)
    assert kernels.launch_counts()["flash_attention"] == n_attn
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=0.05,
                               rtol=0.05)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=5e-3, atol=1e-6)


MCFG = smoke_config(get_arch("mamba2-780m"))


def test_mamba2_teacher_forced_decode_matches_forward(cuda):
    """The JAX package's check (tests/test_models.py) on the card: the
    forward through the ssd kernel against the same tokens one at a time
    through decode_step, atol = rtol = 0.05."""
    params = init_params(MCFG, torch.Generator(device=cuda).manual_seed(0),
                         dtype=torch.bfloat16, device=cuda)
    B, S = 2, 70
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, MCFG.vocab, (B, S)).astype(np.int32)).to(cuda)
    kernels.reset_launch_counts()
    logits, _ = forward(params, MCFG, {"tokens": toks})
    assert kernels.launch_counts()["ssd"] == MCFG.n_layers
    assert kernels.body_launch_counts()["ssd.launches_bf16"] == MCFG.n_layers
    cache = init_cache(MCFG, B, S, device=cuda)
    outs = []
    for t in range(S):
        lg, cache = decode_step(params, MCFG, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1).float(), logits.float(),
                               atol=0.05, rtol=0.05)


def test_mamba2_train_step_through_the_ssd_kernels(cuda):
    """Smoke config, CA k=2 with remat: every layer runs ssd three times a
    microbatch (forward, recompute, states sweep) and ssd_bwd once; the
    step's loss and grad norm match the plain versions' step."""
    metrics = {}
    for backend in ("cuda", "torch"):
        state = init_train_state(MCFG, torch.Generator(
            device=cuda).manual_seed(0), device=cuda)
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, MCFG.vocab, (8, 71),
                                             dtype=np.int32)).to(cuda)
        batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
        with registry.use(backend):
            step = make_train_step(MCFG, ca_k=2, remat=True, warmup=1)
        kernels.reset_launch_counts()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        n = MCFG.n_layers * 2 if backend == "cuda" else 0
        assert launches["ssd_bwd"] == n and launches["ssd"] == 3 * n
        # the model hands bf16 x, B and C: every launch a tensor-core body
        bodies = kernels.body_launch_counts()
        assert (bodies["ssd.launches_bf16"],
                bodies["ssd_bwd.launches_bf16"]) == (3 * n, n)
        metrics[backend] = {k: float(v) for k, v in m.items()}
    assert np.isfinite(metrics["cuda"]["loss"])
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(metrics["cuda"][name],
                                   metrics["torch"][name], rtol=5e-3)


# ------------------------------------------------------------ sync audit --
def test_sync_audit_on_the_card_counts_reads_and_hears_the_runtime(cuda):
    """A CUDA audit counts the Python reads of device tensors (and no host
    tensor's), coalesces them between dispatches, runs the runtime's
    sync-debug check in ``warn`` mode, hears a sync the patches cannot see
    (``nonzero``) as uncounted, and restores the mode it found."""
    prev = torch.cuda.get_sync_debug_mode()
    x = torch.arange(8, dtype=torch.float32, device=cuda) - 3
    with obs.sync_audit(cuda) as a:
        assert torch.cuda.get_sync_debug_mode() == 1          # "warn"
        obs.mark_dispatch("t")
        y = x * 2
        y.cpu()
        float(y[0])
        y.tolist()
        obs.mark_dispatch("t")
        counted = a.runtime_syncs
        torch.nonzero(x)                  # a sync inside C++: uncounted
        obs.mark_dispatch("t")
        block_until_ready(cuda)
        torch.cuda.current_stream().synchronize()
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
        float(torch.ones(2)[0])          # host data
    assert torch.cuda.get_sync_debug_mode() == prev
    assert (a.syncs, a.dispatches, a.transfers) == (2, 3, 6), a.as_dict()
    assert (a.device_get, a.block_until_ready) == (1, 3)
    assert a.runtime_uncounted == 1 and a.runtime_syncs >= counted + 1
    assert a.runtime_syncs - a.runtime_uncounted <= a.transfers


@pytest.mark.parametrize("rule", ["fista", "pnm", "pdhg", "bcd"])
def test_host_loop_audit_on_the_card(cuda, rule):
    """T/k round trips for CA, T classical, each equal to the blocks and
    the marked dispatches; no sync the runtime reports escapes the count;
    the same bits as the solve without the host loop."""
    problem, _ = make_lasso_data(0, d=54, n=20_000, device=cuda)
    cfg = SolverConfig(T=64, k=16, b=0.1, step_size=0.5)
    for ca in (True, False):
        blocks = sstep.HostSyncs()
        with obs.sync_audit(cuda) as a:
            w = sstep.solve(problem, cfg, 3, sstep.RULES[rule], name=rule,
                            ca=ca, host_loop=True, syncs=blocks)
        want = cfg.T // cfg.k if ca else cfg.T
        assert a.syncs == a.dispatches == blocks.blocks == want, a.as_dict()
        assert a.runtime_uncounted == 0
        assert torch.equal(w, sstep.solve(problem, cfg, 3, sstep.RULES[rule],
                                          name=rule, ca=ca))


@pytest.mark.parametrize("mode", [dict(), dict(page_size=5)],
                         ids=["slot", "paged"])
def test_engine_audit_on_the_card_equals_its_stats(cuda, mode):
    """One audited round trip a k-block, equal to ``EngineStats.syncs``,
    all inside the ``serve.decode_block`` span, none the runtime reports
    outside a counted read; streams the same with obs on and off."""
    params = _params(cuda)
    streams = {}
    try:
        for on in (False, True):
            if on:
                obs.reset()
                obs.enable()
            eng = Engine(params, CFG, num_slots=3, max_len=32, k=4,
                         device=cuda, sync_debug=True, **mode)
            with obs.sync_audit(cuda) as a:
                out = eng.run([Request(id=f"r{i}", prompt=p,
                                       max_new_tokens=6)
                               for i, p in enumerate(PROMPTS)])
            s = eng.stats
            assert a.syncs == s.syncs == a.dispatches, a.as_dict()
            # the round's wait: the event behind the outputs' pinned copy
            assert a.block_until_ready == a.transfers == s.syncs
            assert a.runtime_uncounted == 0
            if on:
                assert a.by_span == {"serve.decode_block": s.syncs}
            streams[on] = {r.id: r.tokens for r in out}
    finally:
        obs.disable()
        obs.reset()
    assert streams[True] == streams[False]


# ------------------------------------------------- data-parallel training --
@pytest.mark.parametrize("classical", [False, True], ids=["ca2", "classical"])
def test_dp_train_step_nccl_world_one_is_bitwise_the_single_process(
        cuda, classical):
    """The sharded train step on the data mesh of an NCCL group of one (an
    in-process store), smoke config, two steps: every leaf whole, so two
    all-reduces a step under CA (a microbatch classical) and no
    reduce-scatter, and
    every master, moment and metric bitwise the single-process step's (the
    kernels on both; its tree stacked as JAX's)."""
    from repro_torch.core.distributed import CollectiveCount
    from repro_torch.dist import data_rules
    from repro_torch.launch import mesh
    from repro_torch.launch.steps import shard_train_state
    from repro_torch.tree import leaves
    rng = np.random.default_rng(0)
    toks = [torch.from_numpy(rng.integers(0, CFG.vocab, (8, 17),
                                          dtype=np.int32)).to(cuda)
            for _ in range(2)]
    batches = [dict(tokens=t[:, :-1], labels=t[:, 1:]) for t in toks]
    count = CollectiveCount()
    mesh.init("cuda", rank=0, world_size=1)
    try:
        runs = []
        world = data_rules(torch.distributed.group.WORLD)
        for rules in (world, None):
            state = init_train_state(CFG, torch.Generator(
                device=cuda).manual_seed(0), device=cuda, rules=rules)
            step = make_train_step(CFG, rules, ca_k=2, remat=True, warmup=1,
                                   counter=count,
                                   sync_every_microbatch=classical)
            ms = []
            for b in batches:
                state, m = step(state, b)
                ms.append(m)
            runs.append((state, ms))
        (a, ma), (b, mb) = runs
        b = shard_train_state(CFG, b, world)
    finally:
        mesh.shutdown()
    n = 2 * (2 if classical else 1)
    assert (count.all_reduces, count.reduce_scatters, count.all_gathers) == \
        (2 * n, 0, 0)
    for x, y in zip(leaves(list(a)), leaves(list(b))):
        assert torch.equal(x, y)
    for x, y in zip(ma, mb):
        assert all(torch.equal(x[k], y[k]) for k in x)


def test_sharded_step_world_one_launches_the_flash_kernels(cuda):
    """The sharded CA step at (data, model) = (1, 1) in an NCCL group of
    one dispatches attention to the CUDA kernels (the registry's counts)
    and launches them: the lse forward twice a layer and microbatch
    (remat), flash_dq and flash_dkv once."""
    from repro_torch import kernels
    from repro_torch.dist import Mesh, make_rules
    from repro_torch.kernels import registry
    from repro_torch.launch import mesh
    rng = np.random.default_rng(1)
    t = torch.from_numpy(rng.integers(0, CFG.vocab, (8, 17),
                                      dtype=np.int32)).to(cuda)
    mesh.init("cuda", rank=0, world_size=1)
    try:
        rules = make_rules(Mesh(("data", "model"), (1, 1)),
                           torch.distributed.group.WORLD)
        state = init_train_state(CFG, torch.Generator(
            device=cuda).manual_seed(0), device=cuda, rules=rules)
        step = make_train_step(CFG, rules, ca_k=2, remat=True, warmup=1)
        registry.reset_dispatch_counts()
        kernels.reset_launch_counts()
        state, m = step(state, dict(tokens=t[:, :-1], labels=t[:, 1:]))
        torch.cuda.synchronize()
    finally:
        mesh.shutdown()
    n = 2 * CFG.n_layers
    assert kernels.launch_counts()["flash_dq"] == n
    assert kernels.launch_counts()["flash_dkv"] == n
    assert kernels.launch_counts()["flash_attention"] == 2 * n
    assert registry.dispatch_counts()[("flash_dq", "cuda")] == n
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])


def test_sharded_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A sharded state saved through NCCL (each leaf gathered to rank 0)
    and restored into a template of its layout: every leaf bitwise."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.dist import Mesh, make_rules
    from repro_torch.launch import mesh
    from repro_torch.launch.steps import layout
    from repro_torch.tree import leaves
    mesh.init("cuda", rank=0, world_size=1)
    try:
        rules = make_rules(Mesh(("data", "model"), (1, 1)),
                           torch.distributed.group.WORLD)
        lay = layout(CFG, rules)
        state = init_train_state(CFG, torch.Generator(
            device=cuda).manual_seed(0), device=cuda, rules=rules)
        ck = Checkpointer(tmp_path)
        ck.save(3, state, layout=lay)
        like = init_train_state(CFG, torch.Generator(
            device=cuda).manual_seed(1), device=cuda, rules=rules)
        got, at, _ = ck.restore(like, layout=lay)
    finally:
        mesh.shutdown()
    assert at == 3
    for x, y in zip(leaves(list(got)), leaves(list(state))):
        assert torch.equal(x, y)


@pytest.mark.parametrize("op", ["fista", "pnm"])
def test_prox_block_vjp_on_the_card(cuda, op):
    """The block ops' recompute backward on the card: the forward is the
    CUDA block kernel (one launch), the grads of G, R, the iterates and
    the scalars within 1e-5 normwise of autograd through the plain block
    version on the same inputs."""
    k, d = 8, 54
    A = _randn((k, d, d), 1, cuda)
    G = (A @ A.transpose(1, 2) / d).contiguous()
    R, w_prev, w = (_randn(s, i, cuda) for i, s in
                    enumerate(((k, d), (d,), (d,)), 2))
    cot = _randn((k, d), 5, cuda)
    scal = torch.tensor(SCAL, device=cuda)
    if op == "fista":
        fwd = lambda *a: prox_ops.prox_step_block(*a, j0=3)
        plain = lambda *a: prox_ref.prox_step_block(*a, j0=3)
        inputs = (G, R, w_prev, w, scal)
    else:
        fwd = lambda *a: prox_ops.prox_loop_block(*a, Q=5)
        plain = lambda *a: prox_ref.prox_loop_block(*a, Q=5)
        inputs = (G, R, w, scal)
    grads = []
    for fn in (fwd, plain):
        xs = [t.clone().requires_grad_() for t in inputs]
        kernels.reset_launch_counts()
        W = fn(*xs)
        grads.append(torch.autograd.grad(W, xs, cot))
        if fn is fwd:
            name = "prox_step_block" if op == "fista" else "prox_loop_block"
            assert kernels.launch_counts()[name] == 1
    for g, want in zip(*grads):
        if want.abs().max() == 0:        # lo, hi under l1: no grad
            assert g.abs().max() == 0
        else:
            assert _normwise(g, want) <= 1e-5


# ------------------------------------------------ the rest of serving --
def test_paged_decode_d80_reads_the_pool_in_place(cuda, monkeypatch):
    """zamba2's head dim runs its own instance: no padded call (no copy of
    the pools), one launch a call, and the pools' tensor maps encoded once
    and found again on the next call."""
    def no_pad(*a, **kw):
        raise AssertionError("paged_decode at D=80 went through call_padded")
    monkeypatch.setattr(fa_ops, "call_padded", no_pad)
    args, _ = _paged_case(cuda, B=8, Hq=32, Hkv=32, D=80, P=16, npages=16,
                          kv="bf16")
    fa_ops._MAPS.clear()
    before = fa_ops.paged_decode_cuda.launches
    a = fa_ops.paged_decode_cuda(*args)
    b = fa_ops.paged_decode_cuda(*args)
    torch.cuda.synchronize()
    assert fa_ops.paged_decode_cuda.launches - before == 2
    assert len(fa_ops._MAPS) == 1
    assert torch.equal(a, b)
    want = fa_ref.paged_decode(*args)
    assert _normwise(a.float(), want.float()) <= ATTN_RTOL[a.dtype]


#: chi-squared critical values at alpha = 0.001 (tests/test_sampling.py)
CHI2_999 = {1: 10.83, 2: 13.82, 3: 16.27, 4: 18.47}
SAMPLER_LOGITS = [2.0, 1.0, 0.0, -1.0, 0.5]


def _card_draws(cuda, sp, n, seed):
    """n draws through the sampler on the card: one row a draw, row i keyed
    fold_in(PRNGKey(seed), i) (built on the host), draw index 0."""
    base = np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    keys = np.stack([host_fold_in(base, i) for i in range(n)])
    samp = SlotSampling(
        temperature=torch.full((n,), sp.temperature, device=cuda),
        top_p=torch.full((n,), sp.top_p, device=cuda),
        top_k=torch.full((n,), sp.top_k, dtype=torch.int32, device=cuda),
        key=torch.from_numpy(keys.astype(np.int64)).to(cuda))
    L = torch.tensor(SAMPLER_LOGITS, device=cuda).expand(n, 5).contiguous()
    greedy = L.argmax(-1).to(torch.int32)
    return sample_tokens(L, greedy, samp,
                         torch.zeros(n, dtype=torch.int32, device=cuda)
                         ).cpu().numpy()


@pytest.mark.parametrize("sp,support", [
    (SamplingParams(temperature=0.7), [0, 1, 2, 3, 4]),
    (SamplingParams(temperature=1.0, top_p=0.7), None),
    (SamplingParams(temperature=1.0, top_k=3), [0, 1, 4]),
], ids=["temperature", "top_p", "top_k"])
def test_sampled_draws_on_the_card_match_the_distribution(cuda, sp, support):
    """The on-card draws against the renormalised truncated softmax by the
    chi-squared harness of tests/test_sampling.py; the random bits equal
    the CPU's bit for bit (integer arithmetic)."""
    n = 8000
    toks = _card_draws(cuda, sp, n, seed=11)
    x = np.asarray(SAMPLER_LOGITS, np.float64) / sp.temperature
    probs = np.exp(x - x.max())
    probs /= probs.sum()
    if support is None:                       # the nucleus of top_p
        order = np.argsort(-probs)
        cum = np.cumsum(probs[order])
        support = sorted(order[:int(np.searchsorted(cum, sp.top_p) + 1)])
    assert set(np.unique(toks)) == set(support)
    p = probs[support] / probs[support].sum()
    counts = np.array([(toks == i).sum() for i in support], float)
    stat = float(((counts - p * n) ** 2 / (p * n)).sum())
    assert stat < CHI2_999[len(support) - 1], stat
    key = torch.tensor([[3, 5], [7, 2 ** 32 - 1]], dtype=torch.int64)
    assert torch.equal(tsampling.random_bits(key.to(cuda), 1000).cpu(),
                       tsampling.random_bits(key, 1000))


FAMILY_ARCHS = ["internlm2-1.8b", "granite-moe-1b-a400m", "mamba2-780m",
                "zamba2-2.7b", "whisper-medium", "qwen2-vl-2b"]


def _family_requests(cfg, sampled):
    rng = np.random.RandomState(0)
    reqs = []
    for i, p in enumerate([[7], [3, 11, 5], [9, 2], [4, 4, 4, 8], [13]]):
        enc = rng.randn(16, cfg.d_model).astype(np.float32) \
            if cfg.family == "audio" else None
        sp = SamplingParams(temperature=0.8, top_p=0.9, top_k=8, seed=i) \
            if sampled else None
        reqs.append(Request(id=f"r{i}", prompt=p, max_new_tokens=6,
                            enc_embeds=enc, sampling=sp))
    return reqs


def _family_drain(cuda, cfg, params, sampled, **kw):
    eng = Engine(params, cfg, num_slots=3, max_len=32, k=kw.pop("k", 4),
                 max_prompt=8, enc_len=16 if cfg.family == "audio" else None,
                 device=cuda, sync_debug=True, **kw)
    out = eng.run(_family_requests(cfg, sampled))
    return {r.id: r.tokens for r in out}, eng


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_paged_engine_matches_slot_engine_per_family(cuda, name, sampled):
    """Every family at its smoke config on the card: the paged engine (page
    16, ``paged_decode`` on the pool) gives the slot engine's streams bit
    for bit (its slot cache read through the same kernel), k=1 gives
    k=4's, and the kernel runs once a step per attention layer (never for
    mamba2)."""
    cfg = smoke_config(get_arch(name))
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         dtype=torch.bfloat16, device=cuda)
    slot, _ = _family_drain(cuda, cfg, params, sampled)
    kernels.reset_launch_counts()
    paged, eng = _family_drain(cuda, cfg, params, sampled, page_size=16)
    launches = kernels.launch_counts()["paged_decode"]
    one, _ = _family_drain(cuda, cfg, params, sampled, page_size=16, k=1)
    assert paged == slot == one
    assert all(len(t) == 6 for t in paged.values())
    per_step = (0 if cfg.family == "ssm" else
                cfg.n_layers // cfg.shared_attn_period
                if cfg.family == "hybrid" else cfg.n_layers)
    assert launches == eng.stats.steps * per_step
    assert eng.paged == (cfg.family != "ssm")


def test_overlap_streams_equal_blocking_on_the_card(cuda):
    """The double-buffered loop on the card, sampled, paged: the blocking
    engine's streams bit for bit, hidden syncs counted by the engine and
    by the audit alike."""
    cfg = smoke_config(get_arch("internlm2-1.8b"))
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         dtype=torch.bfloat16, device=cuda)
    want, _ = _family_drain(cuda, cfg, params, True, page_size=16)
    with obs.sync_audit(cuda) as audit:
        got, eng = _family_drain(cuda, cfg, params, True, page_size=16,
                                 overlap=True)
    assert got == want
    s = eng.stats
    assert s.hidden_syncs > 0 and s.steps == s.syncs * 4
    assert audit.syncs == s.syncs == audit.dispatches
    assert audit.overlap_epochs == s.hidden_syncs
    assert audit.runtime_uncounted == 0
    assert not eng._pipe

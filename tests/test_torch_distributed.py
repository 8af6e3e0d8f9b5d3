"""The port's distributed solvers (``repro_torch.core.distributed``) on
torch.distributed, on the CPU: all eight algorithms in spawned gloo ranks at
world 2 and 4 against the JAX package's ``make_distributed_solver`` on a
mesh of the first P spoofed devices, each rank handed the reference's own
draws; one all-reduce a block (T/k for CA, T classical), the same words for
the gram family; CA == classical bit for bit at world 2; and, in a group
of one in this process, w bit for bit the single-process solver's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from repro.core import SolverConfig as JSolverConfig
from repro.core.distributed import (make_distributed_solver as j_solver,
                                    shard_problem as j_shard)
from repro.core.problem import lipschitz_step
from repro.core.sampling import sample_index_batch
from repro.data import make_lasso_data
import repro_torch.core as tcore
from repro_torch.core import distributed as tdist
from repro_torch.core.distributed import (ALGORITHMS, COORD_ALGORITHMS,
                                          CollectiveCount,
                                          make_distributed_solver,
                                          shard_problem)
from repro_torch.launch import mesh

from _torch_port import SOLVER_ATOL, spawn_gloo, to_torch, to_torch_config

KEY = jax.random.PRNGKey(3)
#: the JAX package's distributed parity tolerances
#: (tests/test_distributed.py): BCD's in-block replay reassociates
ATOL = {a: (2e-5 if a in COORD_ALGORITHMS else SOLVER_ATOL)
        for a in ALGORITHMS}


@pytest.fixture(scope="module")
def case():
    """The JAX package's distributed test problem (d=24, n=2048) and cfg."""
    prob, _ = make_lasso_data(jax.random.PRNGKey(0), d=24, n=2048)
    cfg = JSolverConfig(T=48, k=8, b=0.1, Q=5)
    return prob, cfg, float(lipschitz_step(prob.X))


def _rank_draws(cfg, alg, rank, n_local, d):
    """The reference's draws of rank ``rank``: its own fold of the key for
    the gram family, the key itself (shared) for BCD."""
    if alg in COORD_ALGORITHMS:
        idx = sample_index_batch(KEY, cfg.T, d, max(int(cfg.b * d), 1),
                                 False)
    else:
        idx = sample_index_batch(jax.random.fold_in(KEY, rank), cfg.T,
                                 n_local, max(int(cfg.b * n_local), 1),
                                 cfg.with_replacement)
    return to_torch(idx, np.int64)


#: each spawned rank: the eight algorithms on its shard with the handed
#: draws, each with its collective count
_JOB = r"""
import torch
from repro_torch.core import SolverConfig
from repro_torch.core.distributed import (CollectiveCount,
                                          make_distributed_solver,
                                          shard_problem)


def main(rank, world, p):
    cfg = SolverConfig(**p["cfg"])
    X, y = shard_problem(p["X"], p["y"], rank, world)
    out = {}
    for alg, idx in p["draws"][rank].items():
        count = CollectiveCount()
        solve = make_distributed_solver(alg, cfg, p["lam"], counter=count)
        w = solve(X, y, torch.zeros(X.shape[0]), p["t"], idx=idx)
        out[alg] = (w, count.all_reduces, count.words)
    return out
"""


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def spawned(request, case, tmp_path_factory):
    """One spawn a world: rank r runs all eight algorithms; the JAX
    package's run of each on a mesh of the first P devices beside it."""
    P = request.param
    prob, cfg, t = case
    X, y = np.asarray(prob.X), np.asarray(prob.y)
    d, n_local = X.shape[0], X.shape[1] // P
    payload = dict(
        X=to_torch(X), y=to_torch(y), lam=float(prob.lam), t=t,
        cfg=dataclasses.asdict(to_torch_config(cfg)),
        draws=[{a: _rank_draws(cfg, a, r, n_local, d) for a in ALGORITHMS}
               for r in range(P)])
    ranks = spawn_gloo(P, _JOB, payload,
                       tmp_path_factory.mktemp(f"gloo{P}"))
    jmesh = Mesh(np.array(jax.devices()[:P]), ("data",))
    Xs, ys = j_shard(jmesh, prob.X, prob.y)
    ref = {a: np.asarray(j_solver(a, jmesh, cfg, prob.lam)(
        Xs, ys, jnp.zeros(d), jnp.float32(t), KEY)) for a in ALGORITHMS}
    return P, cfg, d, ranks, ref


@pytest.mark.parametrize("alg", ALGORITHMS)
def test_distributed_matches_jax_in_spawned_gloo_ranks(spawned, alg):
    P, cfg, d, ranks, ref = spawned
    w = ranks[0][alg][0]
    for r in range(1, P):        # replicated: every rank holds the same w
        assert torch.equal(ranks[r][alg][0], w)
    assert w.shape == (d,) and torch.isfinite(w).all()
    np.testing.assert_allclose(w.numpy(), ref[alg], atol=ATOL[alg], rtol=0)


def test_distributed_counts_one_all_reduce_a_block(spawned):
    """T/k all-reduces for CA and T classical; the gram family's words are
    T (d^2 + d) either way (Table I); BCD's cross-Gram inflates by k."""
    P, cfg, d, ranks, _ = spawned
    m_c = max(int(cfg.b * d), 1)
    for out in ranks:
        for alg, (_, all_reduces, words) in out.items():
            ca = alg.startswith("ca_")
            assert all_reduces == (cfg.T // cfg.k if ca else cfg.T), alg
            if alg in COORD_ALGORITHMS:
                bm = (cfg.k if ca else 1) * m_c
                assert words == all_reduces * (bm * bm + bm), alg
            else:
                assert words == cfg.T * (d * d + d), alg


def test_distributed_ca_matches_classical(spawned):
    """At world 2 a sum of two is the same either way round, so the gram
    family's CA and classical runs keep the same bits; at world 4 the ring
    reassociates with the buffer's offsets, so they agree to the JAX
    package's tolerance, as BCD's replay does at any world."""
    P, _, _, ranks, _ = spawned
    for alg in ("sfista", "spnm", "pdhg", "bcd"):
        w_cl, w_ca = ranks[0][alg][0], ranks[0]["ca_" + alg][0]
        if P == 2 and alg != "bcd":
            assert torch.equal(w_ca, w_cl), alg
        else:
            np.testing.assert_allclose(w_ca.numpy(), w_cl.numpy(),
                                       atol=ATOL[alg], rtol=0)


@pytest.fixture
def group_of_one():
    """A gloo group of one in this process (an in-process store)."""
    mesh.init("cpu", rank=0, world_size=1)
    try:
        yield
    finally:
        mesh.shutdown()


@pytest.mark.parametrize("alg", ALGORITHMS)
def test_world_one_is_bitwise_the_single_process_solver(case, group_of_one,
                                                        alg):
    """At world 1 the all-reduce is the identity: w has the single-process
    solver's bits on the same draws, with T/k or T all-reduces."""
    prob, cfg, t = case
    tprob = tcore.LassoProblem(X=to_torch(prob.X, np.float32),
                               y=to_torch(prob.y, np.float32),
                               lam=float(prob.lam))
    tcfg = dataclasses.replace(to_torch_config(cfg), step_size=t)
    idx = _rank_draws(cfg, alg, 0, tprob.n, tprob.d)
    count = CollectiveCount()
    solve = make_distributed_solver(alg, tcfg, tprob.lam, counter=count)
    X, y = shard_problem(tprob.X, tprob.y, 0, 1)
    w = solve(X, y, torch.zeros(tprob.d), t, idx=idx)
    want = getattr(tcore, alg)(tprob, tcfg, idx=idx)
    assert torch.equal(w, want)
    assert count.all_reduces == (cfg.T // cfg.k if alg.startswith("ca_")
                                 else cfg.T)


def test_world_one_draws_from_a_seed(case, group_of_one):
    """Without idx the draws come from the seed: the gram family's from
    (seed, rank), BCD's from the seed alone, as a single-process solve on
    the same generator draws them."""
    prob, cfg, t = case
    tprob = tcore.LassoProblem(X=to_torch(prob.X, np.float32),
                               y=to_torch(prob.y, np.float32),
                               lam=float(prob.lam))
    tcfg = dataclasses.replace(to_torch_config(cfg), step_size=t)
    w0 = torch.zeros(tprob.d)
    for alg, seed in (("ca_sfista", tdist.rank_seed(5, 0)), ("ca_bcd", 5)):
        w = make_distributed_solver(alg, tcfg, tprob.lam)(
            tprob.X, tprob.y, w0, t, gen=5)
        assert torch.equal(w, getattr(tcore, alg)(tprob, tcfg, seed))


def test_shard_problem_trims_to_a_multiple_of_the_world():
    X, y = torch.arange(30.).reshape(3, 10), torch.arange(10.)
    parts = [shard_problem(X, y, r, 3) for r in range(3)]
    assert all(p[0].shape == (3, 3) and p[0].is_contiguous() for p in parts)
    assert torch.equal(torch.cat([p[0] for p in parts], 1), X[:, :9])
    assert torch.equal(torch.cat([p[1] for p in parts]), y[:9])
    Xj, yj = j_shard(Mesh(np.array(jax.devices()[:3]), ("data",)),
                     jnp.asarray(X.numpy()), jnp.asarray(y.numpy()))
    assert Xj.shape == (3, 9) and yj.shape == (9,)


def test_distributed_solver_validates():
    with pytest.raises(ValueError, match="unknown algorithm"):
        make_distributed_solver("admm", tcore.SolverConfig(), 0.1)
    cfg = tcore.SolverConfig(T=64, k=8)
    object.__setattr__(cfg, "T", 60)
    with pytest.raises(ValueError, match="ca_pdhg: cfg.T must be divisible"):
        make_distributed_solver("ca_pdhg", cfg, 0.1)
    with pytest.raises(ValueError, match="torchrun"):
        mesh.init("cpu")
    with pytest.raises(ValueError, match="store"):
        mesh.init("cpu", rank=0, world_size=2)
    assert not dist.is_initialized()

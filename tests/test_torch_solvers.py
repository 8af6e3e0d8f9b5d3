"""The port's solvers against the JAX package's, given the same draws and
step size: SFISTA, CA-SFISTA, SPNM and CA-SPNM on the paper's Lasso problem,
the JAX side under ``registry.use("xla")``; and within the port, CA ==
classical, history, one block prox dispatch a k-block with the bits of the
stepwise route, the host loop's block count, validation, the reference
solve, the data generator, the CLI's device default, and that the port
imports neither JAX nor ``repro``."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.cost_model import (CostModel as JCostModel,
                                   MachineParams as JMachineParams)
from repro.data import PAPER_DATASETS as J_DATASETS, make_lasso_data
from repro.core.soft_threshold import fista_momentum as j_fista_momentum
from repro.kernels import registry as jregistry
import repro_torch.core as tcore
from repro_torch.core import sstep, update_rules as ur
from repro_torch.data import PAPER_DATASETS, make_dataset_like
from repro_torch.kernels import registry
from repro_torch.kernels.prox_step.ops import prox_scalars
from repro_torch.launch import lasso_solve

from _torch_port import (SOLVER_ATOL, jax_draws, step_size, to_torch,
                         to_torch_config, to_torch_problem)

KEY = jax.random.PRNGKey(42)
SOLVERS = ["sfista", "ca_sfista", "spnm", "ca_spnm"]
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def problems():
    jprob, _ = make_lasso_data(jax.random.PRNGKey(0), d=32, n=2048)
    return jprob, to_torch_problem(jprob)


@pytest.fixture(scope="module")
def cfg(problems):
    base = jcore.SolverConfig(T=64, k=8, b=0.1, Q=5)
    return dataclasses.replace(base, step_size=step_size(problems[0], base))


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------- parity with JAX -----
@pytest.mark.parametrize("name", SOLVERS)
def test_solver_matches_jax_given_same_draws_and_step(problems, cfg, name):
    jprob, tprob = problems
    with jregistry.use("xla"):
        w_jax = getattr(jcore, name)(jprob, cfg, KEY)
    w = getattr(tcore, name)(tprob, to_torch_config(cfg),
                             idx=jax_draws(KEY, cfg, jprob))
    np.testing.assert_allclose(_np(w), np.asarray(w_jax), atol=SOLVER_ATOL,
                               rtol=0)


def test_history_matches_jax(problems, cfg):
    jprob, tprob = problems
    with jregistry.use("xla"):
        _, h_jax = jcore.ca_spnm(jprob, cfg, KEY, collect_history=True)
    _, h = tcore.ca_spnm(tprob, to_torch_config(cfg),
                         idx=jax_draws(KEY, cfg, jprob), collect_history=True)
    np.testing.assert_allclose(_np(h), np.asarray(h_jax), atol=SOLVER_ATOL,
                               rtol=0)


def test_reference_solve_and_metrics_match_jax(problems, cfg):
    jprob, tprob = problems
    w_jax = jcore.composite_reference(jprob, iters=300,
                                      step_size=cfg.step_size)
    w = tcore.composite_reference(tprob, iters=300, step_size=cfg.step_size)
    np.testing.assert_allclose(_np(w), np.asarray(w_jax), atol=SOLVER_ATOL,
                               rtol=0)
    w1 = w * 0.9
    np.testing.assert_allclose(
        float(tcore.relative_solution_error(w1, w)),
        float(jcore.relative_solution_error(jax.numpy.asarray(_np(w1)),
                                            jax.numpy.asarray(_np(w)))),
        rtol=1e-6)
    np.testing.assert_allclose(float(tcore.lasso_objective(tprob, w)),
                               float(jcore.lasso_objective(jprob, w_jax)),
                               rtol=1e-5)


def test_lipschitz_step_converges_to_jax_step(problems):
    jprob, tprob = problems
    np.testing.assert_allclose(
        float(tcore.lipschitz_step(tprob.X, 300)),
        float(jcore.problem.lipschitz_step(jprob.X, 300)), rtol=1e-4)


@pytest.mark.parametrize("variant", ["l1", "elastic_net", "box", "none"])
def test_prox_elem_and_momentum_match_jax(variant):
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    kw = dict(lam=0.3, mu=0.5, lo=-0.4, hi=0.6)
    np.testing.assert_array_equal(
        _np(tcore.prox_elem(to_torch(x), 0.7, variant, **kw)),
        np.asarray(jcore.prox_elem(jax.numpy.asarray(x), 0.7, variant,
                                   **kw)))
    for j in range(12):
        assert tcore.fista_momentum(j) == float(j_fista_momentum(j))


def test_cost_model_and_datasets_match_jax():
    for P in (1, 64, 1024):
        for ca in (False, True):
            for newton in (False, True):
                a = tcore.CostModel(d=54, n=581_012, b=0.1, T=256, k=32, Q=5)
                b = JCostModel(d=54, n=581_012, b=0.1, T=256, k=32, Q=5)
                assert a.time(P, tcore.MachineParams.comet_like(), ca=ca,
                              newton=newton) == b.time(
                    P, JMachineParams.comet_like(), ca=ca, newton=newton)
    assert PAPER_DATASETS == J_DATASETS


# ------------------------------------------------------- within the port --
@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("pair", [("sfista", "ca_sfista"),
                                  ("spnm", "ca_spnm")], ids=["fista", "pnm"])
def test_ca_matches_classical(problems, cfg, k, pair):
    _, tprob = problems
    tcfg = dataclasses.replace(to_torch_config(cfg), k=k)
    idx = torch.randint(0, tprob.n, (tcfg.T, sstep.draw_size(tprob, tcfg)),
                        generator=torch.Generator().manual_seed(k))
    w_cl, h_cl = getattr(tcore, pair[0])(tprob, tcfg, idx=idx,
                                         collect_history=True)
    w_ca, h_ca = getattr(tcore, pair[1])(tprob, tcfg, idx=idx,
                                         collect_history=True)
    np.testing.assert_allclose(_np(h_ca), _np(h_cl), atol=SOLVER_ATOL)
    assert h_ca.shape == (tcfg.T, tprob.dim)
    assert torch.equal(h_ca[-1], w_ca)


@pytest.mark.parametrize("rule", ["fista", "pnm"])
def test_host_loop_counts_T_over_k_vs_T_blocks(problems, rule):
    _, tprob = problems
    tcfg = tcore.SolverConfig(T=32, k=8, b=0.25, step_size=0.5)
    ca_syncs, cl_syncs = sstep.HostSyncs(), sstep.HostSyncs()
    w_ca = sstep.solve(tprob, tcfg, 7, sstep.RULES[rule], name=f"ca_{rule}",
                       ca=True, host_loop=True, syncs=ca_syncs)
    w_cl = sstep.solve(tprob, tcfg, 7, sstep.RULES[rule], name=rule,
                       host_loop=True, syncs=cl_syncs)
    assert (ca_syncs.blocks, cl_syncs.blocks) == (tcfg.T // tcfg.k, tcfg.T)
    w = sstep.solve(tprob, tcfg, 7, sstep.RULES[rule], name=rule)
    np.testing.assert_allclose(_np(w_cl), _np(w), atol=SOLVER_ATOL)
    np.testing.assert_allclose(_np(w_ca), _np(w_cl), atol=SOLVER_ATOL)
    with pytest.raises(ValueError, match="collect_history"):
        sstep.solve(tprob, tcfg, 7, sstep.RULES[rule], name=rule,
                    host_loop=True, collect_history=True)


#: each rule's block op; a solve dispatches no other update op
BLOCK_OPS = {"fista": "prox_step_block", "pnm": "prox_loop_block"}


@pytest.mark.parametrize("ca", [True, False], ids=["ca", "classical"])
@pytest.mark.parametrize("rule", ["fista", "pnm"])
def test_solve_dispatches_one_block_op_a_block(problems, cfg, rule, ca):
    """T/k block dispatches for CA and T for classical (its k = 1
    instance), one gram_gather each, and never prox_step or prox_loop;
    collect_history stacks the blocks' iterates to (T, d)."""
    _, tprob = problems
    tcfg = to_torch_config(cfg)
    registry.reset_dispatch_counts()
    w, hist = sstep.solve(tprob, tcfg, 5, sstep.RULES[rule], name=rule,
                          ca=ca, collect_history=True)
    blocks = tcfg.T // tcfg.k if ca else tcfg.T
    assert registry.dispatch_counts() == {("gram_gather", "torch"): blocks,
                                          (BLOCK_OPS[rule], "torch"): blocks}
    assert hist.shape == (tcfg.T, tprob.dim) and torch.equal(hist[-1], w)


@pytest.mark.parametrize("ca", [True, False], ids=["ca", "classical"])
@pytest.mark.parametrize("rule", ["fista", "pnm"])
def test_block_schedule_is_bitwise_the_stepwise_route(problems, cfg, rule,
                                                      ca):
    """A solve's history has the bits of the stepwise route: each block's
    Gram pair, then k calls of fista_update / pnm_update."""
    _, tprob = problems
    tcfg = to_torch_config(cfg)
    idx = torch.randint(0, tprob.n, (tcfg.T, sstep.draw_size(tprob, tcfg)),
                        generator=torch.Generator().manual_seed(11))
    _, hist = sstep.solve(tprob, tcfg, None, sstep.RULES[rule], name=rule,
                          ca=ca, idx=idx, collect_history=True)
    variant, lam, mu, lo, hi = tprob.prox_params()
    scal = prox_scalars(sstep._resolve_step(tprob, tcfg), lam, mu, lo, hi)
    block = tcfg.k if ca else 1
    state, rows = ur.init_state(torch.zeros(tprob.dim)), []
    for draws in idx.reshape(tcfg.T // block, block, -1):
        G, R = tprob.block_stats(draws)
        for j in range(block):
            state = (ur.fista_update(G[j], R[j], state, scal, variant=variant)
                     if rule == "fista" else
                     ur.pnm_update(G[j], R[j], state, scal, tcfg.Q,
                                   variant=variant))
            rows.append(state.w)
    assert torch.equal(hist, torch.stack(rows))


@pytest.mark.parametrize("name", ["ca_sfista", "ca_spnm"])
def test_validate_schedule_names_the_solver(problems, name):
    _, tprob = problems
    tcfg = tcore.SolverConfig(T=64, k=8)
    object.__setattr__(tcfg, "T", 60)         # mutated past __post_init__
    with pytest.raises(ValueError, match=f"{name}: cfg.T must be divisible"):
        getattr(tcore, name)(tprob, tcfg, 0)
    with pytest.raises(ValueError, match="multiple of k"):
        tcore.SolverConfig(T=60, k=8)


def test_draws_from_generator_are_reproducible_and_checked(problems):
    _, tprob = problems
    tcfg = tcore.SolverConfig(T=16, k=4, step_size=0.5)
    a = tcore.ca_sfista(tprob, tcfg, torch.Generator().manual_seed(3))
    b = tcore.ca_sfista(tprob, tcfg, 3)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        tcore.sfista(tprob, tcfg, idx=torch.zeros(16, 3, dtype=torch.int64))


def test_sample_columns_batch_equals_per_draw(problems):
    _, tprob = problems
    gen = torch.Generator().manual_seed(0)
    idx = tcore.sample_index_batch(gen, 4, tprob.n, 33)
    assert idx.dtype == torch.int64 and idx.shape == (4, 33)
    assert 0 <= int(idx.min()) and int(idx.max()) < tprob.n
    Xs, ys = tcore.sample_columns(tprob.X, tprob.y, idx)
    assert Xs.shape == (4, tprob.d, 33) and Xs.is_contiguous()
    for j in range(4):
        X1, y1 = tcore.sample_columns(tprob.X, tprob.y, idx[j])
        assert torch.equal(Xs[j], X1) and torch.equal(ys[j], y1)
    G, R = tcore.gram_blocks(tprob.X, tprob.y, idx)
    G1, R1 = tcore.sampled_gram(tprob.X, tprob.y, idx[1])
    np.testing.assert_allclose(_np(G[1]), _np(G1), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(R[1]), _np(R1), rtol=1e-6, atol=1e-7)


def test_gram_blocks_take_G_and_R_from_one_augmented_gram(problems):
    _, tprob = problems
    idx = tcore.sample_index_batch(torch.Generator().manual_seed(1), 3,
                                   tprob.n, 65)
    registry.reset_dispatch_counts()
    G, R = tcore.gram_blocks(tprob.X, tprob.y, idx)
    assert registry.dispatch_counts() == {("gram_gather", "torch"): 1}
    assert G.shape == (3, tprob.d, tprob.d) and R.shape == (3, tprob.d)
    assert G.is_contiguous() and R.is_contiguous()
    Xs, ys = tcore.sample_columns(tprob.X, tprob.y, idx)
    X64, y64 = Xs.double(), ys.double()
    np.testing.assert_allclose(_np(G), _np(X64 @ X64.transpose(1, 2) / 65),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        _np(R), _np(torch.einsum("kdm,km->kd", X64, y64) / 65),
        rtol=1e-6, atol=1e-7)
    assert tprob.Xy is tprob.Xy and tprob.Xy.shape == (tprob.d + 1, tprob.n)
    Gp, Rp = tprob.block_stats(idx)
    assert torch.equal(Gp, G) and torch.equal(Rp, R)


def test_xy_rows_is_xy_sample_major_with_zero_padding(problems):
    _, tprob = problems
    rows = tprob.Xy_rows
    assert rows is tprob.Xy_rows and rows.is_contiguous()
    r_pad = -(-(tprob.d + 1) // 4) * 4
    assert rows.shape == (tprob.n, r_pad) and rows.dtype == torch.float32
    assert torch.equal(rows[:, :tprob.d + 1], tprob.Xy.T)
    assert not rows[:, tprob.d + 1:].any()
    for d, r_pad in ((54, 56), (18, 20), (3, 4), (4, 8)):
        p = tcore.LassoProblem(X=torch.ones(d, 5), y=torch.ones(5))
        assert p.Xy_rows.shape == (5, r_pad)
        assert not p.Xy_rows[:, d + 1:].any()


# ------------------------------------------------------ data and launch ---
def test_make_dataset_like_sizes_and_seed():
    p1, w1 = make_dataset_like("covtype", scale=0.01, device="cpu")
    p2, w2 = make_dataset_like("covtype", scale=0.01, device="cpu")
    assert (p1.d, p1.n) == (54, int(58_101 * 0.01))
    assert torch.equal(p1.X, p2.X) and torch.equal(w1, w2)
    assert p1.lam > 0 and p1.X.dtype == torch.float32
    assert int(PAPER_DATASETS["covtype"]["n"] * 10) == 581_010
    assert int(PAPER_DATASETS["susy"]["n"] * 50) == 5_000_000


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default runs on it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        lasso_solve.main(["--scale", "0.01"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_dataset_like("abalone")


@pytest.mark.parametrize("algorithm", SOLVERS)
def test_lasso_solve_cli_on_cpu(capsys, algorithm):
    run = lasso_solve.main(["--device", "cpu", "--scale", "0.01",
                            "--dataset", "susy", "--algorithm", algorithm,
                            "--T", "64", "--k", "8"])
    out = capsys.readouterr().out
    assert "rel_err=" in out and "predicted CA speedup" in out
    assert run.w.shape == (18,) and torch.isfinite(run.w).all()
    assert 0.0 <= run.rel_err < 1.0
    # the CPU run takes the plain versions: no kernel is launched
    assert run.launches == {"gram": 0, "gram_gather": 0, "prox_step": 0,
                            "prox_loop": 0, "prox_step_block": 0,
                            "prox_loop_block": 0, "pdhg_block": 0,
                            "prox_rows": 0, "flash_attention": 0,
                            "paged_decode": 0, "flash_dq": 0, "flash_dkv": 0,
                            "ssd": 0, "ssd_bwd": 0}


def test_lasso_solve_tol_stops_early():
    run = lasso_solve.main(["--device", "cpu", "--scale", "0.01",
                            "--dataset", "abalone", "--T", "256", "--k", "8",
                            "--tol", "0.5"])
    assert run.iters < 256 and run.rel_err <= 0.5


def test_port_imports_no_jax_and_nothing_of_repro(tmp_path):
    code = r"""
import importlib, pkgutil, sys
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
from repro_torch.launch import lasso_solve
import repro_torch.models, repro_torch.serve, repro_torch.launch.serve
import repro_torch.launch.train
run = lasso_solve.main(["--device", "cpu", "--scale", "0.01", "--T", "16",
                        "--k", "4", "--algorithm", "ca_spnm"])
out = repro_torch.launch.serve.main(["--device", "cpu", "--preset", "tiny",
                                     "--page-size", "5", "--requests", "2",
                                     "--new-tokens", "3"])
assert len(out) == 2
trained = repro_torch.launch.train.main(["--device", "cpu", "--preset",
                                         "tiny", "--steps", "2",
                                         "--ckpt-dir", sys.argv[1]])
assert len(trained.metrics_log) == 2
ssm = repro_torch.launch.train.main(["--device", "cpu", "--arch",
                                     "mamba2-780m", "--preset", "tiny",
                                     "--steps", "2", "--ckpt-dir",
                                     sys.argv[1] + "/ssm"])
assert len(ssm.metrics_log) == 2
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
print("ISOLATED", run.rel_err)
"""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "ISOLATED" in out.stdout


# ------------------------------------- the rest of the family: PDHG, BCD --
#: the JAX package's problems of tests/test_sstep.py, one of each family
def _family():
    jnp = jax.numpy
    kX, kw, kn = jax.random.split(KEY, 3)
    X = jax.random.normal(kX, (16, 256))
    w_true = jax.random.normal(kw, (16,))
    y = X.T @ w_true + 0.1 * jax.random.normal(kn, (256,))
    labels = jnp.sign(X.T @ w_true + 1e-3)
    return {"lasso": jcore.LassoProblem(X, y, lam=0.05),
            "enet": jcore.ElasticNetProblem(X, y, lam=0.05, mu=0.05),
            "svm": jcore.DualSVMProblem(X, labels, C=1.0)}


FAMILY = _family()
FAMILY_SOLVERS = ["pdhg", "ca_pdhg", "bcd", "ca_bcd"]
#: the JAX package's tolerances (tests/test_sstep.py): BCD's in-block
#: replay reassociates a matrix-vector product
FAMILY_ATOL = {"pdhg": SOLVER_ATOL, "bcd": 2e-5}


def _family_case(name, cfg=None):
    """(JAX problem, port problem, cfg with the JAX package's step t)."""
    jprob = FAMILY[name]
    base = cfg or jcore.SolverConfig(T=64, k=8, b=0.25)
    t = float(jprob.default_step(base))
    return (jprob, to_torch_problem(jprob),
            dataclasses.replace(base, step_size=t))


def _schedule(solver):
    return "coord" if solver.endswith("bcd") else "gram"


@pytest.mark.parametrize("variant", ["l1", "elastic_net", "box", "none"])
def test_moreau_dual_prox_matches_jax(variant):
    from repro.core.soft_threshold import moreau_dual_prox
    x = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    kw = dict(lam=0.3, mu=0.5, lo=-0.4, hi=0.6)
    for sigma in (0.25, 1.7):
        np.testing.assert_allclose(
            _np(tcore.moreau_dual_prox(to_torch(x), sigma, variant, **kw)),
            np.asarray(moreau_dual_prox(jax.numpy.asarray(x), sigma,
                                        variant, **kw)), rtol=1e-6,
            atol=1e-7)


@pytest.mark.parametrize("solver", FAMILY_SOLVERS)
@pytest.mark.parametrize("problem", ["lasso", "enet", "svm"])
def test_family_matches_jax_given_same_draws_and_step(problem, solver):
    """PDHG, CA-PDHG, BCD and CA-BCD on each problem family: the port's
    history against the JAX package's (XLA backend), the same draws and
    step, at the JAX package's own tolerances."""
    jprob, tprob, cfg = _family_case(problem)
    with jregistry.use("xla"):
        _, h_jax = getattr(jcore, solver)(jprob, cfg, KEY,
                                          collect_history=True)
    idx = jax_draws(KEY, cfg, jprob, _schedule(solver))
    w, h = getattr(tcore, solver)(tprob, to_torch_config(cfg), idx=idx,
                                  collect_history=True)
    atol = FAMILY_ATOL[solver.removeprefix("ca_")]
    assert h.shape == (cfg.T, tprob.dim) and torch.equal(h[-1], w)
    np.testing.assert_allclose(_np(h), np.asarray(h_jax), atol=atol, rtol=0)


@pytest.mark.parametrize("pair", ["pdhg", "bcd"])
@pytest.mark.parametrize("problem", ["lasso", "enet", "svm"])
def test_family_ca_matches_classical(problem, pair):
    """Same draws: CA-PDHG is PDHG bit for bit (one pdhg_block a k-block,
    its k = 1 instance per step); CA-BCD is BCD to the JAX package's
    tolerance (the in-block replay reassociates C_j @ delta)."""
    _, tprob, cfg = _family_case(problem)
    tcfg = to_torch_config(cfg)
    idx = sstep.draws(tprob, tcfg, 9, None,
                      "coord" if pair == "bcd" else "gram")
    w_cl, h_cl = getattr(tcore, pair)(tprob, tcfg, idx=idx,
                                      collect_history=True)
    w_ca, h_ca = getattr(tcore, "ca_" + pair)(tprob, tcfg, idx=idx,
                                              collect_history=True)
    if pair == "pdhg":
        assert torch.equal(h_ca, h_cl) and torch.equal(w_ca, w_cl)
    else:
        np.testing.assert_allclose(_np(h_ca), _np(h_cl),
                                   atol=FAMILY_ATOL["bcd"], rtol=0)
    if problem == "svm" and pair == "bcd":
        # the box prox keeps every BCD iterate dual-feasible (PDHG's primal
        # iterate q - t u is not a prox output)
        assert float(h_ca.min()) >= 0.0 and float(h_ca.max()) <= 1.0 + 1e-6


def test_pdhg_sigma_inv_t_collapses_to_ista():
    """At sigma = 1/t (and u0 = 0) each PDHG iteration is the ISTA step
    prox_{t g}(q): against a hand-rolled ISTA on the same Gram pairs, at
    the JAX package's tolerance for this oracle (tests/test_sstep.py)."""
    _, tprob, cfg = _family_case("lasso", jcore.SolverConfig(T=32, k=8,
                                                             b=0.25))
    tcfg = dataclasses.replace(to_torch_config(cfg),
                               sigma=1.0 / cfg.step_size)
    idx = sstep.draws(tprob, tcfg, 4, None)
    _, hist = tcore.ca_pdhg(tprob, tcfg, idx=idx, collect_history=True)
    t = torch.tensor(cfg.step_size)
    w = torch.zeros(tprob.d)
    for j in range(tcfg.T):
        G, R = tprob.block_stats(idx[j:j + 1])
        w = tcore.prox_elem(w - t * (G[0] @ w - R[0]), t, "l1",
                            lam=tprob.lam)
        np.testing.assert_allclose(_np(hist[j]), _np(w), atol=1e-4)


@pytest.mark.parametrize("ca", [True, False], ids=["ca", "classical"])
@pytest.mark.parametrize("problem", ["lasso", "svm"])
def test_pdhg_block_is_bitwise_the_stepwise_route(problem, ca):
    """A PDHG solve's history has the bits of the stepwise route: each
    block's Gram pairs, then k calls of pdhg_update; one gram_gather (gram
    for the dual SVM) and one pdhg_block dispatch a block."""
    _, tprob, cfg = _family_case(problem)
    tcfg = to_torch_config(cfg)
    idx = sstep.draws(tprob, tcfg, 11, None)
    registry.reset_dispatch_counts()
    _, hist = tcore.ca_pdhg(tprob, tcfg, idx=idx, collect_history=True) \
        if ca else tcore.pdhg(tprob, tcfg, idx=idx, collect_history=True)
    blocks = tcfg.T // tcfg.k if ca else tcfg.T
    stats = "gram" if problem == "svm" else "gram_gather"
    assert registry.dispatch_counts() == {(stats, "torch"): blocks,
                                          ("pdhg_block", "torch"): blocks}
    variant, lam, mu, lo, hi = tprob.prox_params()
    scal = prox_scalars(torch.tensor(tcfg.step_size), lam, mu, lo, hi)
    sigma = ur.pdhg_sigma(None, scal[0])
    block = tcfg.k if ca else 1
    state, rows = ur.init_pdhg_state(torch.zeros(tprob.dim)), []
    for draws in idx.reshape(tcfg.T // block, block, -1):
        G, R = tprob.block_stats(draws)
        for j in range(block):
            state = ur.pdhg_update(G[j], R[j], state, scal, sigma,
                                   variant=variant)
            rows.append(state.w)
    assert torch.equal(hist, torch.stack(rows))


@pytest.mark.parametrize("problem", ["lasso", "svm"])
def test_bcd_dispatches_one_gram_a_block(problem):
    _, tprob, cfg = _family_case(problem)
    tcfg = to_torch_config(cfg)
    for solver, blocks in ((tcore.ca_bcd, tcfg.T // tcfg.k),
                           (tcore.bcd, tcfg.T)):
        registry.reset_dispatch_counts()
        solver(tprob, tcfg, 2)
        assert registry.dispatch_counts() == {("gram", "torch"): blocks}


@pytest.mark.parametrize("rule", ["pdhg", "bcd"])
def test_host_loop_counts_T_over_k_vs_T_blocks_for_the_family(problems,
                                                              rule):
    _, tprob = problems
    tcfg = tcore.SolverConfig(T=32, k=8, b=0.25, step_size=0.5)
    ca_syncs, cl_syncs = sstep.HostSyncs(), sstep.HostSyncs()
    w_ca = sstep.solve(tprob, tcfg, 7, sstep.RULES[rule], name=f"ca_{rule}",
                       ca=True, host_loop=True, syncs=ca_syncs)
    w_cl = sstep.solve(tprob, tcfg, 7, sstep.RULES[rule], name=rule,
                       host_loop=True, syncs=cl_syncs)
    assert (ca_syncs.blocks, cl_syncs.blocks) == (tcfg.T // tcfg.k, tcfg.T)
    w = sstep.solve(tprob, tcfg, 7, sstep.RULES[rule], name=rule)
    assert torch.equal(w_cl, w)
    np.testing.assert_allclose(_np(w_ca), _np(w_cl), atol=2e-5)


def test_problem_statistics_match_jax():
    """Each family's sampled pair (with and without the global m_norm), its
    full-batch pair and its coordinate view, against the JAX package's."""
    idx = np.array([[3, 17, 17, 200], [0, 5, 9, 255]])
    for name in ("lasso", "enet", "svm"):
        jprob = FAMILY[name]
        tprob = to_torch_problem(jprob)
        units = jprob.n_units
        jidx = idx % units
        for m_norm in (None, 37):
            G, R = tprob.block_stats(torch.from_numpy(jidx), m_norm=m_norm)
            for j in range(2):
                with jregistry.use("xla"):
                    jG, jR = jprob.gram_stats(jax.numpy.asarray(jidx[j]),
                                              m_norm=m_norm)
                np.testing.assert_allclose(_np(G[j]), np.asarray(jG),
                                           rtol=1e-5, atol=1e-6)
                np.testing.assert_allclose(_np(R[j]), np.asarray(jR),
                                           rtol=1e-5, atol=1e-6)
        for got, want in zip(tprob.full_stats(), jprob.full_stats()):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                       atol=1e-6)
        view, jview = tprob.coord_view(), jprob.coord_view()
        for f in ("B", "offset", "lin"):
            np.testing.assert_array_equal(_np(getattr(view, f)),
                                          np.asarray(getattr(jview, f)))
        assert view.inv_rho == pytest.approx(jview.inv_rho, rel=1e-12)
        assert tprob.prox_params() == jprob.prox_params()
        assert (tprob.dim, tprob.n_units) == (jprob.dim, jprob.n_units)
        w = to_torch(np.linspace(0, 1, jprob.dim), np.float32)
        np.testing.assert_allclose(
            float(tprob.objective(w)),
            float(jprob.objective(jax.numpy.asarray(_np(w)))), rtol=1e-5)
        np.testing.assert_allclose(
            float(tprob.default_step(tcore.SolverConfig(power_iters=300))),
            float(jprob.default_step(jcore.SolverConfig(power_iters=300))),
            rtol=1e-4)


@pytest.mark.parametrize("algorithm", FAMILY_SOLVERS)
def test_lasso_solve_cli_runs_the_family_on_cpu(capsys, algorithm):
    run = lasso_solve.main(["--device", "cpu", "--scale", "0.01",
                            "--dataset", "covtype", "--algorithm", algorithm,
                            "--T", "64", "--k", "8"])
    assert "rel_err=" in capsys.readouterr().out
    assert run.w.shape == (54,) and torch.isfinite(run.w).all()
    assert 0.0 <= run.rel_err < 1.0
    assert not any(run.launches.values())

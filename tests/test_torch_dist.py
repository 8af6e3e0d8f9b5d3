"""The port's distribution and training helpers against the JAX package, on
the CPU: the sharding rules' specs (``repro_torch.dist.sharding``) for every
arch on the production meshes, ``largest_mesh_shape``, the elastic remesh
with the fault-tolerant runner in spawned gloo ranks (world 4 -> 3),
gradient compression bit for bit, the prox block ops' recompute backward
against ``jax.vjp``, and ``launch.grad_smoke``."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as jconfigs
from repro.dist.compat import spoof_mesh
from repro.dist.elastic import largest_mesh_shape as j_largest_mesh_shape
from repro.dist.sharding import cache_specs as j_cache_specs
from repro.dist.sharding import fit_spec as j_fit_spec
from repro.dist.sharding import make_rules as j_make_rules
from repro.dist.sharding import param_specs as j_param_specs
from repro.kernels import registry as jregistry
from repro.core.soft_threshold import fista_momentum as j_fista_momentum
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.optim import compression as jcomp
from repro_torch.configs import get_arch
from repro_torch.dist import (Mesh, fit_spec, largest_mesh_shape,
                              make_rules, param_specs, cache_specs)
from repro_torch.kernels import registry
from repro_torch.kernels.prox_step import ops as prox_ops
from repro_torch.kernels.prox_step import ref as prox_ref
from repro_torch.launch import grad_smoke
from repro_torch.models import init_cache, init_params
from repro_torch.optim import compression as tcomp
from repro_torch.tree import leaves

from _torch_port import spawn_gloo

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _both_rules(name):
    shape, names = MESHES[name]
    return (j_make_rules(spoof_mesh(shape, names)),
            make_rules(Mesh(names, shape)))


def _jspecs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _specs(tree):
    """The port's spec tree's leaves (each spec a tuple), dict keys
    sorted, as ``jax.tree.leaves`` orders them."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _specs(tree[k])]
    if isinstance(tree, list):
        return [s for sub in tree for s in _specs(sub)]
    return [tree]


# ------------------------------------------------------------- specs ---
def test_fit_spec_matches_jax():
    shape, names = MESHES["multipod"]
    jmesh, mesh = spoof_mesh(shape, names), Mesh(names, shape)
    cases = [((("pod", "data"),), (64,)), ((("pod", "data"),), (2,)),
             ((("pod", "data"), "model"), (96, 48)),
             (("data", None, "model"), (16, 3, 40)),
             ((("pod", "data", "model"),), (1024,)), ((None,), (7,)),
             (("data", "model"), (5,))]
    for spec, dims in cases:
        assert fit_spec(spec, dims, mesh) == tuple(
            j_fit_spec(P(*spec), dims, jmesh)), (spec, dims)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_param_specs_equal_jax(name, mesh_name):
    """Every leaf of every full config (the port's tree on the ``meta``
    device, JAX's by ``eval_shape``) on both production meshes, sharded
    and gathered: the same spec, a layer stack's in JAX's stacked layout,
    and the bulk of the parameters sharded."""
    jrules, rules = _both_rules(mesh_name)
    jcfg, cfg = jconfigs.get_arch(name), get_arch(name)
    sds = jax.eval_shape(lambda k: j_init_params(jcfg, k),
                         jax.ShapeDtypeStruct((2,), jnp.uint32))
    params = init_params(cfg, None, dtype=torch.float32, device="meta")
    for gather in (False, True):
        jspec = j_param_specs(sds, jrules, gather_fsdp=gather)
        spec = param_specs(params, rules, gather_fsdp=gather)
        assert sorted(spec) == sorted(jspec)
        for key in jspec:
            assert _specs(spec[key]) == _jspecs(jspec[key]), key
    sharded = [s for s in _specs(param_specs(params, rules))
               if any(e is not None for e in s)]
    big = [t for t in jax.tree.leaves(sds) if t.size > 1_000_000]
    assert len(sharded) >= len(big) * 3 // 4


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_cache_specs_equal_jax(name, mesh_name):
    """The decode cache of every arch (batch 128, 32,768 positions; meta
    tensors) on both meshes: the same spec for every leaf."""
    jrules, rules = _both_rules(mesh_name)
    jcfg, cfg = jconfigs.get_arch(name), get_arch(name)
    sds = jax.eval_shape(lambda: j_init_cache(jcfg, 128, 32768,
                                              enc_len=32768))
    cache = init_cache(cfg, 128, 32768, device="meta", enc_len=32768)
    jspec = j_cache_specs(sds, jrules)
    spec = cache_specs(cache, rules)
    assert sorted(spec) == sorted(jspec)
    for key in jspec:
        assert _specs(spec[key]) == _jspecs(jspec[key]), key


def test_rules_logical_axes_and_constrain():
    shape, names = MESHES["multipod"]
    rules = make_rules(Mesh(names, shape))
    assert rules.dp == ("pod", "data") and rules.tp == "model"
    assert rules.dp_size == 32 and rules.tp_size == 16
    assert rules.n_devices == 512 and rules.group is None
    assert rules.logical_spec(("batch", None, "tp")) == (
        ("pod", "data"), None, "model")
    x = torch.ones(3)
    assert rules.constrain(x, ("batch",)) is x
    data = make_rules(Mesh(("data",), (4,)))
    assert data.dp == "data" and data.tp is None and data.dp_size == 4


def test_largest_mesh_shape_matches_jax():
    for n in (1, 3, 8, 16, 255, 256, 511, 512):
        for model in (1, 4, 16):
            assert largest_mesh_shape(n, model) == tuple(
                j_largest_mesh_shape(n, model))


# ------------------------------------------------------ elastic remesh ---
#: each spawned rank: the fault-tolerant runner over the smoke config's
#: sharded CA step on a (world, 1) mesh, the leaves sharded as a full
#: config's are (``_MIN_SHARD_BYTES_ELEMS`` lowered to 128: at data 4 the
#: projections split over the data axis, at 3, which divides none of the
#: smoke widths, they are whole). ``fail`` at step 3 with ranks 0-2
#: surviving (elastic), or a clean run from the checkpoint the directory
#: holds.
_RUNNER_JOB = r"""
import torch
import torch.distributed as dist
import repro_torch.dist.sharding as sharding
from repro_torch.configs import get_arch, smoke_config
from repro_torch.data import TokenStream
from repro_torch.dist import FailureSource, Mesh, TrainingRunner, make_rules
from repro_torch.launch.steps import init_train_state, layout, make_train_step
from repro_torch.tree import leaves


def main(rank, world, p):
    sharding._MIN_SHARD_BYTES_ELEMS = 128
    cfg = smoke_config(get_arch("internlm2-1.8b"))
    built = []

    def builder(rules):
        built.append(rules.dp_size)
        return make_train_step(cfg, rules, ca_k=2, peak_lr=1e-3, warmup=1,
                               total_steps=6, remat=False)

    def data(start):
        return TokenStream(batch=24, seq=16, vocab=cfg.vocab, seed=0,
                           start_step=start, device="cpu")

    def init_state(rules):
        return init_train_state(cfg, torch.Generator().manual_seed(0),
                                device="cpu", rules=rules)

    fail = FailureSource(p["fail_at"], survivors=p["survivors"])
    rules = make_rules(Mesh(("data", "model"), (world, 1)), dist.group.WORLD)
    runner = TrainingRunner(builder, rules, data, init_state, p["dir"],
                            ckpt_every=2, failure_source=fail, elastic=True,
                            layout=lambda r: layout(cfg, r))
    state = runner.run(6)
    if state is None:
        return dict(left=runner.left, built=built)
    return dict(left=runner.left, built=built, restarts=runner.restarts,
                mesh=runner.rules.mesh.sizes,
                split=[lf.data_dim is not None for lf in
                       layout(cfg, runner.rules).leaves],
                params=[t.clone() for t in leaves(state.params)],
                steps=[m["step"] for m in runner.metrics_log],
                losses=[m["loss"] for m in runner.metrics_log])
"""


def test_remesh_world4_to_3_restores_and_matches_a_clean_world3_run(
        tmp_path):
    """World 4 on a (4, 1) mesh fails at step 3 with ranks 0-2 surviving:
    rank 3 leaves, the survivors remesh to the (3, 1) mesh
    (``largest_mesh_shape``), rebuild the step, restore the step-2
    checkpoint, written once for the job as global leaves, into the (3, 1)
    layout, and finish; every survivor's master shards equal those of a
    clean world-3 run from that checkpoint, bit for bit."""
    run = tmp_path / "elastic"
    got = spawn_gloo(4, _RUNNER_JOB, dict(fail_at=[3], survivors=[0, 1, 2],
                                          dir=str(run)), tmp_path / "j4",
                     timeout=240)
    assert got[3]["left"] and got[3]["built"] == [4]
    for r in range(3):
        assert not got[r]["left"] and got[r]["restarts"] == 1
        assert got[r]["built"] == [4, 3] and got[r]["mesh"] == (3, 1)
        assert got[r]["steps"] == list(range(6))
    assert sorted(p.name for p in run.iterdir()) == [
        "step_2", "step_4", "step_6"]          # one directory for the job
    clean = tmp_path / "clean"
    shutil.copytree(run / "step_2", clean / "step_2")
    want = spawn_gloo(3, _RUNNER_JOB, dict(fail_at=[], survivors=None,
                                           dir=str(clean)), tmp_path / "j3",
                      timeout=240)
    assert want[0]["steps"] == [2, 3, 4, 5] and want[0]["restarts"] == 0
    assert want[0]["losses"] == got[0]["losses"][2:]
    assert any(want[0]["split"]) is False
    for r in range(3):
        for a, b in zip(got[r]["params"], want[r]["params"]):
            assert torch.equal(a, b)


#: each spawned rank: the train CLI in the rank's group (RANK and
#: WORLD_SIZE set, as torchrun sets them)
_CLI_JOB = r"""
import os
from repro_torch.launch import train


def main(rank, world, p):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    runner = train.main(["--device", "cpu", "--preset", "tiny", "--steps",
                         "6", "--ckpt-every", "2", "--fail-at", "3",
                         "--ckpt-dir", p["dir"]])
    return dict(restarts=runner.restarts, log=runner.metrics_log,
                rules=(runner.rules.mesh.sizes, runner.rules.mesh.axis_names,
                       runner.rules.coords))
"""


def test_train_cli_trains_data_parallel_in_a_group(tmp_path):
    """The train CLI at world 2 (gloo): the mesh JAX's CLI picks for two
    devices, (data, model) = (1, 2), internlm2 tensor-parallel over it,
    one restart after the failure at step 3, the same metrics on both
    ranks, one checkpoint directory for the job."""
    got = spawn_gloo(2, _CLI_JOB, dict(dir=str(tmp_path / "ck")),
                     tmp_path / "job", timeout=240)
    for r, out in enumerate(got):
        assert out["restarts"] == 1
        assert out["rules"] == ((1, 2), ("data", "model"), (0, r))
        assert [m["step"] for m in out["log"]] == list(range(6))
        assert out["log"] == got[0]["log"]
        assert all(np.isfinite(m["loss"]) for m in out["log"])
    assert (tmp_path / "ck" / "step_6").is_dir()
    assert not any(p.name.startswith("rank")
                   for p in (tmp_path / "ck").iterdir())


# --------------------------------------------------------- compression ---
def _distinct(seed, shape):
    """Values of distinct magnitude (a permutation of 1..n, scaled, with
    random signs), so top-k's choice has no tie."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    mags = (rng.permutation(n) + 1).astype(np.float32) / n
    return (mags * rng.choice([-1.0, 1.0], n)).astype(np.float32).reshape(
        shape)


@pytest.mark.parametrize("shape,frac", [((1000,), 0.01), ((64, 48), 0.05),
                                        ((7, 3, 5), 0.5), ((10,), 0.0)])
def test_topk_matches_jax_bit_for_bit(shape, frac):
    g = _distinct(0, shape)
    jc, jres = jcomp.topk_compress(jnp.asarray(g), frac)
    tc, tres = tcomp.topk_compress(torch.from_numpy(g), frac)
    np.testing.assert_array_equal(tc.values.numpy(), np.asarray(jc.values))
    np.testing.assert_array_equal(tc.indices.numpy(), np.asarray(jc.indices))
    assert tc.indices.dtype == torch.int32
    np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(jc.scale))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    dec = tcomp.topk_decompress(tc, shape)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(
        jcomp.topk_decompress(jc, shape)))
    # error feedback: the kept values and the residual rebuild g exactly
    assert torch.equal(dec + tres, torch.from_numpy(g))


def test_topk_ties_keep_the_lower_index_first():
    g = np.array([1.0, -3.0, 3.0, 2.0, -3.0, 0.5], np.float32)
    jc, _ = jcomp.topk_compress(jnp.asarray(g), 0.5)
    tc, _ = tcomp.topk_compress(torch.from_numpy(g), 0.5)
    np.testing.assert_array_equal(tc.indices.numpy(), np.asarray(jc.indices))
    assert tc.indices.tolist() == [1, 2, 4]


@pytest.mark.parametrize("shape", [(1000,), (64, 48), (3,)])
def test_int8_matches_jax_bit_for_bit(shape):
    g = 3.0 * _distinct(1, shape)
    jc, jres = jcomp.int8_compress(jnp.asarray(g))
    tc, tres = tcomp.int8_compress(torch.from_numpy(g))
    assert tc.values.dtype == torch.int8 and tc.indices.numel() == 0
    np.testing.assert_array_equal(tc.values.numpy(), np.asarray(jc.values))
    np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(jc.scale))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    deq = tcomp.int8_decompress(tc, shape)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(
        jcomp.int8_decompress(jc, shape)))
    assert torch.equal(torch.from_numpy(g) - deq - tres,
                       torch.zeros(shape))


# ------------------------------------------------------------ prox VJP ---
SCAL = (0.05, 0.02, 0.3, -0.1, 0.2)      # t, lam, mu, lo, hi


def _prox_inputs(seed, k, d):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((k, d, d)).astype(np.float32)
    G = (A @ A.transpose(0, 2, 1) / d).astype(np.float32)
    R, w_prev, w = (rng.standard_normal(s).astype(np.float32)
                    for s in ((k, d), (d,), (d,)))
    cot = rng.standard_normal((k, d)).astype(np.float32)
    return G, R, w_prev, w, cot


def _j_fista_block(G, R, w_prev, w, t, lam, mu, lo, hi, j0, variant):
    """k FISTA steps: the JAX op ``prox_step`` (its Pallas kernel in
    interpret mode, with the recompute VJP) scanned over the block."""
    def step(carry, gr):
        wp, wc, j = carry
        mom = j_fista_momentum(j)
        v = wc + mom * (wc - wp)
        wn = jregistry.dispatch("prox_step", gr[0], gr[1], v, t, lam,
                                mu=mu, lo=lo, hi=hi, variant=variant)
        return (wc, wn, j + 1), wn
    return jax.lax.scan(step, (w_prev, w, jnp.int32(j0)), (G, R))[1]


def _j_pnm_block(G, R, z0, t, lam, mu, lo, hi, Q, variant):
    def step(z, gr):
        zn = jregistry.dispatch("prox_loop", gr[0], gr[1], z, t, lam, Q=Q,
                                mu=mu, lo=lo, hi=hi, variant=variant)
        return zn, zn
    return jax.lax.scan(step, z0, (G, R))[1]


def _tensors(*arrays):
    return [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]


@pytest.mark.parametrize("variant", ["l1", "elastic_net", "box", "none"])
def test_prox_step_block_vjp_matches_jax(variant):
    """The block op's grads (G, R, w_prev, w, t and lam: JAX's custom VJP
    binds mu, lo and hi as static keywords) through ``RecomputeFn`` against
    ``jax.vjp`` of the JAX op (its Pallas kernel in interpret mode and the
    recompute VJP) scanned over a block of k = 5 at d = 12, from j0 = 3
    (momentum on), to 1e-5 normwise."""
    G, R, w_prev, w, cot = _prox_inputs(0, 5, 12)
    t, lam, mu, lo, hi = SCAL
    with jregistry.use("pallas"):
        out, pull = jax.vjp(lambda G, R, a, b, t, lam:
                            _j_fista_block(G, R, a, b, t, lam, mu, lo, hi,
                                           3, variant),
                            G, R, w_prev, w, jnp.float32(t),
                            jnp.float32(lam))
        want = pull(jnp.asarray(cot))
    tG, tR, tp, tw = _tensors(G, R, w_prev, w)
    scal = torch.tensor(SCAL, requires_grad=True)
    W = prox_ops.prox_step_block(tG, tR, tp, tw, scal, j0=3, variant=variant)
    np.testing.assert_allclose(W.detach().numpy(), np.asarray(out),
                               atol=1e-6)
    got = torch.autograd.grad(W, [tG, tR, tp, tw, scal],
                              torch.from_numpy(cot))
    got = list(got[:4]) + list(got[4][:2].unbind())
    for i, (g, w_) in enumerate(zip(got, want)):
        w_ = np.asarray(w_)
        err = np.abs(g.numpy() - w_).max() / max(np.abs(w_).max(), 1e-30)
        assert err <= 1e-5 or np.abs(w_).max() == np.abs(g.numpy()).max() \
            == 0, f"input {i}: {err:.3e}"


@pytest.mark.parametrize("variant", ["l1", "box"])
def test_prox_loop_block_vjp_matches_jax(variant):
    """The same for k = 4 proximal Newton steps of Q = 3 at d = 9."""
    G, R, _, z0, cot = _prox_inputs(1, 4, 9)
    t, lam, mu, lo, hi = SCAL
    with jregistry.use("pallas"):
        out, pull = jax.vjp(lambda G, R, z, t, lam:
                            _j_pnm_block(G, R, z, t, lam, mu, lo, hi, 3,
                                         variant),
                            G, R, z0, jnp.float32(t), jnp.float32(lam))
        want = pull(jnp.asarray(cot))
    tG, tR, tz = _tensors(G, R, z0)
    scal = torch.tensor(SCAL, requires_grad=True)
    W = prox_ops.prox_loop_block(tG, tR, tz, scal, Q=3, variant=variant)
    np.testing.assert_allclose(W.detach().numpy(), np.asarray(out),
                               atol=1e-6)
    got = torch.autograd.grad(W, [tG, tR, tz, scal], torch.from_numpy(cot))
    got = list(got[:3]) + list(got[3][:2].unbind())
    for i, (g, w_) in enumerate(zip(got, want)):
        w_ = np.asarray(w_)
        err = np.abs(g.numpy() - w_).max() / max(np.abs(w_).max(), 1e-30)
        assert err <= 1e-5 or np.abs(w_).max() == np.abs(g.numpy()).max() \
            == 0, f"input {i}: {err:.3e}"


def test_prox_block_ops_dispatch_once_and_only_differentiate_on_demand():
    """Without grad the block op is the registry's op (one dispatch, the
    solves' path, unchanged bits); with an input that needs grad its
    forward is that same dispatch, and only the inputs that need a grad get
    one."""
    G, R, w_prev, w, cot = _prox_inputs(2, 3, 6)
    scal = torch.tensor(SCAL)
    tG, tR, tp, tw = map(torch.from_numpy, (G, R, w_prev, w))
    registry.reset_dispatch_counts()
    plain = prox_ops.prox_step_block(tG, tR, tp, tw, scal, j0=0)
    assert registry.dispatch_counts() == {("prox_step_block", "torch"): 1}
    assert torch.equal(plain, prox_ref.prox_step_block(tG, tR, tp, tw, scal,
                                                       j0=0))
    tw.requires_grad_()
    W = prox_ops.prox_step_block(tG, tR, tp, tw, scal, j0=0)
    assert torch.equal(W.detach(), plain)
    (gw,) = torch.autograd.grad(W, [tw], torch.from_numpy(cot))
    assert gw.shape == tw.shape and torch.isfinite(gw).all()


# ---------------------------------------------------------- grad smoke ---
def test_grad_smoke_on_cpu(capsys):
    """One arch a family (the JAX script's pick), loss and grads finite,
    the grad norm positive."""
    assert grad_smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in ("whisper-medium", "internlm2-1.8b", "zamba2-2.7b",
                 "deepseek-moe-16b", "mamba2-780m", "qwen2-vl-2b"):
        assert f"{name}" in out
    assert out.count(" OK") == 6 and "backend=torch" in out
    assert grad_smoke.family_archs() == [
        "whisper-medium", "internlm2-1.8b", "zamba2-2.7b",
        "deepseek-moe-16b", "mamba2-780m", "qwen2-vl-2b"]


def test_grad_smoke_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default runs on it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        grad_smoke.main([])

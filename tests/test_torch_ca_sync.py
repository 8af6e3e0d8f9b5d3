"""The paper's communication schedule in the port's training, on
torch.distributed, on the CPU: the data-parallel CA train step
(``launch.steps.make_train_step`` with ``Rules``) and the CA-sync solvers
(``optim.ca_sync``) in spawned gloo ranks at world 2 and 4, against the JAX
package's on a mesh of the first P spoofed devices.

- The DP step (internlm2 and mamba2 at the smoke config, CA k=2 and the
  classical schedule, two steps): loss, grad norm, lr, the first moment and
  each leaf's update against JAX's ``make_train_step(cfg,
  make_rules(mesh))``, at the tolerances of ``tests/test_torch_train.py``
  (the ranks' shards gathered whole on rank 0); its collectives a step
  (``ca_k`` reduce-scatters and one all-reduce under CA, each once a
  microbatch classical, with their words); every rank's masters in JAX's
  layout, which at the smoke widths replicates every leaf, so bitwise
  equal across ranks; and, in a gloo group of one in this process,
  bitwise the single-device step. ``tests/test_torch_fsdp.py`` holds the
  sharded layouts shard for shard.
- ``ca_local_sgd_solver`` and ``ca_stale_k_solver`` against JAX's on
  ``tests/test_stale_k.py``'s Lasso objective at its tolerances, one
  collective a round, the staleness bound of exactly one round, and on the
  LM the port's stale-k against the port's synchronous solver (JAX's own
  LM parity test fails in the reference: ROADMAP queue 3 item 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as PSpec

import repro.configs as jconfigs
from repro.data import make_lasso_data, make_token_batch
from repro.dist.sharding import make_rules as j_make_rules
from repro.dist.sharding import param_specs as j_param_specs
from repro.kernels import registry as jregistry
from repro.launch.steps import init_train_state as j_init_train_state
from repro.launch.steps import make_train_step as j_make_train_step
from repro.optim import ca_local_sgd_solver as j_local_sgd
from repro.optim import ca_stale_k_solver as j_stale_k
from repro_torch.core.distributed import CollectiveCount
from repro_torch.dist import data_rules
from repro_torch.launch import mesh
from repro_torch.launch.steps import make_train_step, shard_train_state
from repro_torch.models import params_from_numpy, train_state_from_numpy
from repro_torch.tree import leaves

from _torch_port import spawn_gloo, to_torch_config_arch

ARCHS = ("internlm2-1.8b", "mamba2-780m")
#: the tolerances of tests/test_torch_train.py (JAX's own grad tolerance,
#: about one bf16 step on the scalars, Adam's first update normwise)
GRAD_TOL = dict(atol=5e-3, rtol=5e-2)
SCALAR_RTOL = 5e-3
UPDATE_RTOL = 0.3
ADAM_B1 = 0.9
CA_K, STEPS = 2, 2
KW = dict(ca_k=CA_K, peak_lr=1e-3, warmup=0, total_steps=10)
#: tests/test_stale_k.py's Lasso harness
LASSO = dict(d=8, n=512, k=4, rounds=12, lr=0.05, rows=8)


def _cfg(name):
    return jconfigs.smoke_config(jconfigs.get_arch(name))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_batches(seed0, n=STEPS, batch=8, seq=16, vocab=256):
    out = []
    for i in range(n):
        toks, labels = make_token_batch(jax.random.PRNGKey(seed0 + i),
                                        batch, seq, vocab)
        out.append(dict(tokens=toks, labels=labels))
    return out


def _lasso_batches(P):
    prob, _ = make_lasso_data(jax.random.PRNGKey(0), LASSO["d"], LASSO["n"])
    X, y = np.asarray(prob.X), np.asarray(prob.y)
    rng = np.random.RandomState(0)
    out = []
    for _ in range(LASSO["rounds"]):
        idx = rng.randint(0, LASSO["n"], size=(LASSO["k"],
                                               P * LASSO["rows"]))
        out.append((X.T[idx].astype(np.float32), y[idx].astype(np.float32)))
    return out


def _lm_batches(P, rounds=6, k=2, seq=16):
    """tests/test_stale_k.py's LM rounds (one row a rank a local step), its
    first batch every round, so that a falling loss shows the trajectory
    optimizes rather than which rows a round drew."""
    toks, labels = make_token_batch(jax.random.PRNGKey(100), k * P, seq, 256)
    return [dict(tokens=np.array(toks).reshape(k, P, seq),
                 labels=np.array(labels).reshape(k, P, seq))] * rounds


#: each spawned rank: the DP step cases, the Lasso solvers, the staleness
#: probe and the LM solvers; it imports torch and repro_torch only
_JOB = r"""
import torch
import torch.distributed as dist
from repro_torch.configs import get_arch, smoke_config
from repro_torch.core.distributed import CollectiveCount
from repro_torch.dist import data_rules
from repro_torch.launch.steps import (TrainState, init_train_state, layout,
                                      make_train_step, shard_train_state)
from repro_torch.models import init_params, loss_fn
from repro_torch.optim.ca_sync import ca_local_sgd_solver, ca_stale_k_solver
from repro_torch.tree import leaves


def whole(lay, tree):
    # the port's tree of whole leaves on rank 0 (None elsewhere)
    full = [lay.full_leaf(i, t) for i, t in enumerate(leaves(tree))]
    return None if full[0] is None else leaves(lay.unstack(full))


def dp_case(p, name, classical):
    cfg = smoke_config(get_arch(name))
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    with torch.no_grad():
        for t, v in zip(leaves(params), p["params"][name]):
            t.copy_(v)
    rules = data_rules(dist.group.WORLD)
    lay = layout(cfg, rules)
    state = shard_train_state(cfg, TrainState(params, None), rules)
    count = CollectiveCount()
    step = make_train_step(cfg, rules, remat=name.startswith("mamba2"),
                           sync_every_microbatch=classical, counter=count,
                           **p["kw"])
    out = dict(metrics=[], params=[], m=[], counts=[], shards=[],
               n_replicated=lay.n_replicated)
    for batch in p["batches"][name]:
        before = dict(vars(count))
        state, m = step(state, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params"].append(whole(lay, state.params))
        out["m"].append(whole(lay, state.opt.m))
        out["shards"].append([t.clone() for t in leaves(state.params)])
        out["counts"].append({k: v - before[k]
                              for k, v in vars(count).items()})
    return out


def lasso(p):
    def loss(w, batch):
        xb, yb = batch
        return torch.mean((xb @ w - yb) ** 2)
    k, lr = p["lasso"]["k"], p["lasso"]["lr"]
    d = p["lasso"]["d"]
    c_sync, c_stale = CollectiveCount(), CollectiveCount()
    sync = ca_local_sgd_solver(loss, k=k, lr=lr, counter=c_sync)
    stale = ca_stale_k_solver(loss, k=k, lr=lr, counter=c_stale)
    w = torch.zeros(d)
    carry = stale.init(torch.zeros(d))
    sync_l, stale_l = [], []
    for xb, yb in p["lasso_batches"]:
        w, ls = sync(w, (xb, yb))
        carry, lt = stale.step(carry, (xb, yb))
        sync_l.append(float(ls))
        stale_l.append(lt)
    final = stale.finalize(carry).clone()
    return dict(sync_w=w.clone(), sync_losses=sync_l, stale_w=final,
                stale_losses=[float(t) for t in stale_l],
                sync_count=(c_sync.all_reduces, c_sync.words),
                stale_count=(c_stale.all_reduces, c_stale.words),
                waits=list(stale.waits))


def staleness(world):
    k, lr, damping = 2, 0.5, 0.5
    stale = ca_stale_k_solver(lambda w, b: torch.mean(b @ w), k=k, lr=lr,
                              damping=damping)
    carry = stale.init(torch.zeros(3))
    seen, losses = [], []
    for i in range(3):
        carry, loss = stale.step(carry, torch.full((k, world, 3),
                                                    float(i + 1)))
        seen.append(carry.params.clone())
        losses.append(loss)
    peek = stale.finalize(carry).clone()
    again = stale.finalize(carry).clone()
    return dict(seen=seen, final=peek, again=again,
                losses=[float(t) for t in losses], waits=list(stale.waits))


def lm(p):
    import types
    import repro_torch.models.transformer as transformer
    from repro_torch.models import init_params
    cfg = smoke_config(get_arch("internlm2-1.8b"))
    if p.get("lm_float32_stream", True):
        # the model's bf16 casts would round the two solvers' params, equal
        # to float32 rounding, apart by a bf16 step
        shim = types.SimpleNamespace(**{k: getattr(torch, k)
                                        for k in dir(torch)
                                        if not k.startswith("__")})
        shim.bfloat16 = torch.float32
        transformer.torch = shim
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
    lm_loss = lambda prm, b: loss_fn(prm, cfg, b)
    sync = ca_local_sgd_solver(lm_loss, k=2, lr=5e-3)
    stale = ca_stale_k_solver(lm_loss, k=2, lr=5e-3)
    p_sync, carry = params, stale.init(params)
    sync_l, stale_l = [], []
    for b in p["lm_batches"]:
        p_sync, ls = sync(p_sync, b)
        carry, lt = stale.step(carry, b)
        sync_l.append(float(ls))
        stale_l.append(lt)
    final = stale.finalize(carry)
    return dict(sync_losses=sync_l, stale_losses=[float(t) for t in stale_l],
                sync=[t.clone() for t in leaves(p_sync)],
                stale=[t.clone() for t in leaves(final)])


def main(rank, world, p):
    out = {f"{name}/{int(cl)}": dp_case(p, name, cl)
           for name in p["archs"] for cl in (False, True)}
    out["lasso"] = lasso(p)
    out["staleness"] = staleness(world)
    out["lm"] = lm(p)
    return out
"""


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def spawned(request, tmp_path_factory):
    """One spawn a world; JAX's sharded step and solvers on a mesh of the
    first P devices beside it."""
    P = request.param
    jmesh = Mesh(np.array(jax.devices()[:P]), ("data",))
    jrules = j_make_rules(jmesh)
    payload = dict(archs=list(ARCHS), kw=KW, params={}, batches={},
                   lasso=LASSO, lm_batches=[{k: torch.from_numpy(v) for k, v
                                             in b.items()}
                                            for b in _lm_batches(P)])
    payload["lasso_batches"] = [tuple(map(torch.from_numpy, b))
                                for b in _lasso_batches(P)]
    ref = {}
    for i, name in enumerate(ARCHS):
        cfg = _cfg(name)
        tcfg = to_torch_config_arch(cfg)
        jstate = j_init_train_state(cfg, jax.random.PRNGKey(0))
        state0 = train_state_from_numpy(tcfg, _np_tree(jstate))
        payload["params"][name] = leaves(state0.params)
        batches = _jax_batches(10 + 10 * i, vocab=cfg.vocab)
        payload["batches"][name] = [
            {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
            for b in batches]
        for classical in (False, True):
            with jregistry.use("xla"):
                jstep = jax.jit(j_make_train_step(
                    cfg, jrules, remat=False,
                    sync_every_microbatch=classical, **KW))
            st, steps = jstate, []
            for b in batches:
                st, m = jstep(st, b)
                steps.append(({k: float(v) for k, v in m.items()},
                              _np_tree(st.params), _np_tree(st.opt.m)))
            ref[f"{name}/{int(classical)}"] = (tcfg, leaves(state0.params),
                                               steps)

    def jloss(w, batch):
        xb, yb = batch
        return jnp.mean((xb @ w - yb) ** 2)
    sync = j_local_sgd(jloss, jmesh, k=LASSO["k"], lr=LASSO["lr"])
    stale = j_stale_k(jloss, jmesh, k=LASSO["k"], lr=LASSO["lr"])
    w, carry = jnp.zeros(LASSO["d"]), stale.init(jnp.zeros(LASSO["d"]))
    jl_sync, jl_stale = [], []
    for xb, yb in _lasso_batches(P):
        w, ls = sync(w, (jnp.asarray(xb), jnp.asarray(yb)))
        carry, lt = stale.step(carry, (jnp.asarray(xb), jnp.asarray(yb)))
        jl_sync.append(float(ls))
        jl_stale.append(float(lt))
    ref["lasso"] = dict(sync_w=np.asarray(w), sync_losses=jl_sync,
                        stale_w=np.asarray(stale.finalize(carry)),
                        stale_losses=jl_stale)
    ranks = spawn_gloo(P, _JOB, payload, tmp_path_factory.mktemp(f"ca{P}"),
                       timeout=300)
    return P, ranks, ref


def _update_rel(params, params0, want):
    out = []
    for p, p0, w in zip(params, params0, want):
        got, exp = (p - p0).double(), (w - p0).double()
        out.append(float((got - exp).norm() / exp.norm().clamp_min(1e-30)))
    return np.array(out)


@pytest.mark.parametrize("classical", [False, True], ids=["ca2", "classical"])
@pytest.mark.parametrize("name", ARCHS)
def test_dp_step_matches_jax_sharded_step(spawned, name, classical):
    """Rank 0's loss, grad norm and lr a step, its first moment (at
    GRAD_TOL scaled by 1 - b1) and each leaf's update against JAX's
    sharded step from the same state on the same global batches."""
    P, ranks, ref = spawned
    key = f"{name}/{int(classical)}"
    tcfg, params0, steps = ref[key]
    got = ranks[0][key]
    m_tol = dict(atol=(1 - ADAM_B1) * GRAD_TOL["atol"],
                 rtol=GRAD_TOL["rtol"])
    for i, (jm, jparams, jmom) in enumerate(steps):
        m = got["metrics"][i]
        np.testing.assert_allclose(m["lr"], jm["lr"], rtol=1e-6)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[k], jm[k], rtol=SCALAR_RTOL,
                                       err_msg=f"{key} step {i + 1} {k}")
        want_m = leaves(params_from_numpy(tcfg, jmom, dtype=torch.float32))
        for j, (a, b) in enumerate(zip(got["m"][i], want_m)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **m_tol,
                                       err_msg=f"{key} m leaf {j}")
        want_p = leaves(params_from_numpy(tcfg, jparams, dtype=torch.float32))
        rel = _update_rel(got["params"][i], params0, want_p)
        assert rel.max() <= UPDATE_RTOL, (
            f"{key} world {P} step {i + 1}: leaf {rel.argmax()} update off "
            f"JAX's by {rel.max():.3f} normwise (limit {UPDATE_RTOL})")


@pytest.mark.parametrize("classical", [False, True], ids=["ca2", "classical"])
@pytest.mark.parametrize("name", ARCHS)
def test_dp_step_counts_and_replicated_masters(spawned, name, classical):
    """JAX's layout on the data mesh: at the smoke widths its specs
    replicate every leaf (each under ``_MIN_SHARD_BYTES_ELEMS``), so every
    rank holds each master whole, in JAX's stacked shape, bitwise rank 0's
    after every step. Nothing is split over the data axis, so no gather
    and no reduce-scatter: a CA step makes one all-reduce of every
    gradient and the loss over the data group, and one of the squared
    norm; classical, the two a microbatch."""
    P, ranks, ref = spawned
    key = f"{name}/{int(classical)}"
    jrules = j_make_rules(Mesh(np.array(jax.devices()[:P]), ("data",)))
    jstate = j_init_train_state(_cfg(name), jax.random.PRNGKey(0))
    specs = jax.tree.leaves(j_param_specs(jstate.params, jrules),
                            is_leaf=lambda x: isinstance(x, PSpec))
    shapes = [t.shape for t in jax.tree.leaves(jstate.params)]
    assert all(e is None for s in specs for e in s)
    per = CA_K if classical else 1
    for r, out in enumerate(ranks):
        n = out[key]["n_replicated"]
        assert n == sum(int(np.prod(s)) for s in shapes)
        for counts in out[key]["counts"]:
            assert counts == dict(all_gathers=0, reduce_scatters=0,
                                  all_reduces=2 * per,
                                  words=per * (n + 2)), (r, counts)
        for step, (a_s, b_s) in enumerate(zip(out[key]["shards"],
                                              ranks[0][key]["shards"])):
            assert [tuple(a.shape) for a in a_s] == shapes
            for a, b in zip(a_s, b_s):
                assert torch.equal(a, b), (r, step)


@pytest.fixture
def group_of_one():
    mesh.init("cpu", rank=0, world_size=1)
    try:
        yield
    finally:
        mesh.shutdown()


@pytest.mark.parametrize("classical", [False, True], ids=["ca2", "classical"])
def test_dp_step_at_world_one_is_bitwise_the_single_device_step(
        group_of_one, classical):
    """In a gloo group of one the collectives are the identity: two steps
    of the sharded step on the data mesh of one (2 or 2 ca_k all-reduces a
    step) leave every master, moment and metric bitwise the single-device
    step's, its tree stacked as JAX's."""
    cfg = _cfg("internlm2-1.8b")
    tcfg = to_torch_config_arch(cfg)
    jstate = _np_tree(j_init_train_state(cfg, jax.random.PRNGKey(0)))
    count = CollectiveCount()
    runs = []
    world = data_rules(torch.distributed.group.WORLD)
    for rules in (world, None):
        state = train_state_from_numpy(tcfg, jstate)
        if rules is not None:
            state = shard_train_state(tcfg, state, rules)
        step = make_train_step(tcfg, rules, remat=False, counter=count,
                               sync_every_microbatch=classical, **KW)
        ms = []
        for b in _jax_batches(30, vocab=cfg.vocab):
            state, m = step(state, {k: torch.from_numpy(np.array(v))
                                    for k, v in b.items()})
            ms.append(m)
        runs.append((state, ms))
    assert count.all_reduces == 2 * STEPS * (CA_K if classical else 1)
    (a, ma), (b, mb) = runs
    b = shard_train_state(tcfg, b, world)        # JAX's stacked layout
    for x, y in zip(leaves(list(a)), leaves(list(b))):
        assert torch.equal(x, y)
    for x, y in zip(ma, mb):
        assert all(torch.equal(x[k], y[k]) for k in x)


def test_dp_step_validates_its_batch_and_rules(group_of_one):
    cfg = to_torch_config_arch(_cfg("internlm2-1.8b"))
    from repro_torch.dist import Mesh, make_rules
    with pytest.raises(ValueError, match="group of 1 ranks"):
        make_train_step(cfg, make_rules(Mesh(("data",), (2,)),
                                        torch.distributed.group.WORLD))
    from repro_torch.launch.steps import _split
    with pytest.raises(ValueError, match="ca_k 2 x world 3"):
        _split({"tokens": torch.zeros(8, 4)}, 2, 0, 3)
    rows = [mb["tokens"][:, 0].tolist() for mb in _split(
        {"tokens": torch.arange(12.)[:, None]}, 2, 1, 3)]
    # microbatch i is rows [6 i, 6 i + 6); rank 1 of 3 takes its 2nd third
    assert rows == [[2.0, 3.0], [8.0, 9.0]]


# ----------------------------------------------------------- CA-sync ---
def test_ca_sync_solvers_match_jax_on_lasso(spawned):
    """tests/test_stale_k.py's Lasso harness: the port's synchronous and
    stale-k solvers against JAX's, round by round (rtol 2e-5) and at the end
    (atol 1e-5); stale-k (damping 1) against the port's own synchronous
    trajectory as well; both optimize."""
    P, ranks, ref = spawned
    want = ref["lasso"]
    for out in ranks:
        got = out["lasso"]
        np.testing.assert_allclose(got["sync_losses"], want["sync_losses"],
                                   rtol=2e-5)
        np.testing.assert_allclose(got["stale_losses"],
                                   want["stale_losses"], rtol=2e-5)
        np.testing.assert_allclose(got["sync_w"].numpy(), want["sync_w"],
                                   atol=1e-5)
        np.testing.assert_allclose(got["stale_w"].numpy(), want["stale_w"],
                                   atol=1e-5)
        np.testing.assert_allclose(got["stale_losses"], got["sync_losses"],
                                   rtol=2e-5)
        np.testing.assert_allclose(got["stale_w"].numpy(),
                                   got["sync_w"].numpy(), atol=1e-5)
        assert got["stale_losses"][-1] < 0.5 * got["stale_losses"][0]
        assert torch.equal(got["sync_w"], ranks[0]["lasso"]["sync_w"])


def test_ca_sync_solvers_make_one_collective_a_round(spawned):
    """One all-reduce a round each, of the parameters (or the delta) and
    the loss; every stale-k collective waited in the round after its own,
    or by finalize, never inside it."""
    P, ranks, _ = spawned
    rounds, d = LASSO["rounds"], LASSO["d"]
    for out in ranks:
        got = out["lasso"]
        assert got["sync_count"] == (rounds, rounds * (d + 1))
        assert got["stale_count"] == (rounds, rounds * (d + 1))
        assert got["waits"] == [(t, t + 1) for t in range(rounds)]


def test_staleness_bound_exactly_one_round(spawned):
    """The JAX package's probe: a linear loss makes each round's delta a
    constant (-lr k c_i), so the params after round t show exactly which
    aggregates have landed: those of rounds 0..t-1, damped, nothing newer;
    finalize lands the last once and leaves the carry as it was."""
    P, ranks, _ = spawned
    k, lr, damping = 2, 0.5, 0.5
    deltas = [-lr * k * float(i + 1) for i in range(3)]
    for out in ranks:
        got = out["staleness"]
        for t, seen in enumerate(got["seen"]):
            np.testing.assert_allclose(seen.numpy(),
                                       damping * sum(deltas[:t]), rtol=1e-6)
        np.testing.assert_allclose(got["final"].numpy(),
                                   damping * sum(deltas), rtol=1e-6)
        assert torch.equal(got["final"], got["again"])
        assert got["waits"] == [(0, 1), (1, 2), (2, 3)]
        # the round's mean loss, filled when its aggregate landed: from
        # w = v (every entry), k = 2 steps of 3 c w give 3 c (v - lr c / 2)
        want = [3 * c * (damping * sum(deltas[:t]) - lr * c / 2)
                for t, c in enumerate((1.0, 2.0, 3.0))]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-6)


def test_stale_k_matches_the_ports_sync_solver_on_the_lm(spawned):
    """The LM smoke transformer (internlm2, its stream in float32): stale-k
    with damping 1 against the port's synchronous local-SGD, per round
    (rtol 1e-4) and at the end (atol 2e-4, rtol 1e-3), the tolerances of
    JAX's LM parity test, which fails in the reference itself. In the bf16
    stream the two solvers' params, p + mean(moved - p) against
    mean(moved), differ by float32 rounding, and the model's bf16 copy of
    the weights turns that into a bf16 step in some weights: the per-round
    losses then part by up to 2.7e-4 relative at world 4 on the CPU
    (``python tests/test_torch_ca_sync.py`` prints it), a likely cause of
    the reference's own failure. The loss falls."""
    P, ranks, _ = spawned
    for out in ranks:
        got = out["lm"]
        np.testing.assert_allclose(got["stale_losses"], got["sync_losses"],
                                   rtol=1e-4)
        for a, b in zip(got["stale"], got["sync"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4,
                                       rtol=1e-3)
        assert got["stale_losses"][-1] < got["stale_losses"][0]


if __name__ == "__main__":
    # The LM stale-k against sync gap in the bf16 stream, world 4 (not a
    # test: the reason the test above runs the LM in a float32 stream):
    #   PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/test_torch_ca_sync.py
    import tempfile
    P = 4
    job = _JOB.replace("    out = {f\"{name}/{int(cl)}\": dp_case(p, name, cl)\n"
                       "           for name in p[\"archs\"] for cl in "
                       "(False, True)}\n", "    out = {}\n")
    with tempfile.TemporaryDirectory() as tmp:
        payload = dict(lasso=LASSO, lm_float32_stream=False,
                       lasso_batches=[tuple(map(torch.from_numpy, b))
                                      for b in _lasso_batches(P)],
                       lm_batches=[{k: torch.from_numpy(v) for k, v in
                                    b.items()} for b in _lm_batches(P)])
        got = spawn_gloo(P, job, payload, tmp, timeout=300)[0]["lm"]
    rel = np.abs(np.subtract(got["stale_losses"], got["sync_losses"])) / \
        np.abs(got["sync_losses"])
    print(f"world {P}, bf16 stream: stale-k against sync per-round losses, "
          f"max relative difference {rel.max():.3e} (the test's limit 1e-4)")

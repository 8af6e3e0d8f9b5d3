"""JAX's FSDP x TP specs applied to the port's tensors, on the CPU:
``launch.steps.make_train_step(cfg, rules)`` in spawned gloo ranks (one
session a world size, 2 and 4, carrying every case of that world) against
the JAX package's ``make_train_step(cfg, make_rules(mesh))`` on a mesh of
the same spoofed devices, rank r being device r.

Both packages' ``_MIN_SHARD_BYTES_ELEMS`` are lowered to 128 elements for
the session (JAX's through ``monkeypatch``, the ranks' by assignment), so
that the smoke configs' leaves are sharded as a full config's are: the
projections over the data and the model axes, an (L, d) norm gain's stack
dim L over the data axis, the 1-D leaves replicated.

- internlm2 at (data, model) = (2, 1), (1, 2) and (2, 2), CA (ca_k 2) and
  classical, two steps: loss and grad norm at ``SCALAR_RTOL``, and each
  rank's float32 master, m and v shard, in JAX's stacked layout, of the
  shape and the values of JAX's ``addressable_shards`` on the same device:
  m elementwise at ``GRAD_TOL`` scaled by 1 - b1; the masters' update
  and v normwise, each layer's leaf as ``tests/test_torch_ca_sync.py``
  holds the replicated step's (the ranks' shards put where JAX's
  ``devices_indices_map`` puts the same devices' shards: Adam's first
  update is +-lr wherever a gradient is not tiny, and a small shard's norm
  is ruled by the signs of its few tiny gradients); mamba2 and granite
  (CA) at (2, 1), granite against JAX's Pallas path (interpret mode), as
  ``tests/test_torch_families.py`` holds MoE grads (JAX's XLA path splits
  the routing);
- the collectives a step, by kind and words; the grad norm counting a
  leaf replicated over an axis once; a checkpoint written at (2, 1) and
  restored at (1, 2);
- in this process: ``shard_shape`` and ``shard_slice`` against
  ``NamedSharding`` for all ten archs (meta tensors), the (1, 1) mesh in a
  gloo group of one bitwise the single-device step, and a family other
  than dense raising for a model axis past 1.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import repro.configs as jconfigs
import repro.dist.sharding as jsharding
from repro.data import make_token_batch
from repro.dist.compat import spoof_mesh
from repro.dist.sharding import make_rules as j_make_rules
from repro.dist.sharding import param_specs as j_param_specs
from repro.kernels import registry as jregistry
from repro.launch.steps import init_train_state as j_init_train_state
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import init_params as j_init_params
from repro_torch.configs import get_arch
from repro_torch.dist import Mesh, make_rules
from repro_torch.dist.sharding import shard_coords, shard_shape, shard_slice
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.steps import (init_train_state, layout,
                                      make_train_step)
from repro_torch.models import train_state_from_numpy
from repro_torch.tree import leaves

from _torch_port import spawn_gloo, to_torch_config_arch

#: tests/test_torch_ca_sync.py's tolerances
GRAD_TOL = dict(atol=5e-3, rtol=5e-2)
SCALAR_RTOL = 5e-3
UPDATE_RTOL = 0.3
ADAM_B1 = 0.9
#: v holds squared gradients: twice the gradients' relative tolerance,
#: normwise as the masters' updates
V_RTOL = 2 * GRAD_TOL["rtol"]
CA_K, STEPS = 2, 2
KW = dict(ca_k=CA_K, peak_lr=1e-3, warmup=0, total_steps=10)
MIN_SHARD = 128
#: (arch, mesh, classical) of each world's session
CASES = {2: [("internlm2-1.8b", (2, 1), False),
             ("internlm2-1.8b", (2, 1), True),
             ("internlm2-1.8b", (1, 2), False),
             ("internlm2-1.8b", (1, 2), True),
             ("mamba2-780m", (2, 1), False),
             ("granite-moe-1b-a400m", (2, 1), False)],
         4: [("internlm2-1.8b", (2, 2), False),
             ("internlm2-1.8b", (2, 2), True)]}


def _cfg(name):
    return jconfigs.smoke_config(jconfigs.get_arch(name))


def _key(name, mesh, classical):
    return f"{name}/{mesh[0]}x{mesh[1]}/{int(classical)}"


def _batches(name, seed0):
    cfg = _cfg(name)
    out = []
    for i in range(STEPS):
        toks, labels = make_token_batch(jax.random.PRNGKey(seed0 + i), 8, 16,
                                        cfg.vocab)
        out.append(dict(tokens=np.asarray(toks), labels=np.asarray(labels)))
    return out


def _np_state(st):
    """A JAX TrainState as plain dicts of CPU tensors (the spawned ranks
    import no JAX and load tensors only)."""
    tree = lambda t: jax.tree.map(   # noqa: E731
        lambda a: torch.from_numpy(np.array(a)), t)
    return dict(params=tree(st.params), step=int(st.opt.step),
                m=tree(st.opt.m), v=tree(st.opt.v))


def _shards(tree, devices):
    """Each device's shard of every leaf of ``tree`` (JAX arrays), in leaf
    order: {device index: [numpy shard, ...]}."""
    out = {i: [] for i in range(len(devices))}
    for leaf in jax.tree.leaves(tree):
        by_dev = {s.device: np.asarray(s.data) for s in leaf.addressable_shards}
        for i, d in enumerate(devices):
            out[i].append(by_dev[d])
    return out


def _where(tree, devices):
    """Each leaf's (full shape, [index of device i's shard, ...], whether
    it is a layer stack), in leaf order."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        index = leaf.sharding.devices_indices_map(leaf.shape)
        out.append((leaf.shape, [index[d] for d in devices],
                    path[0].key in ("layers", "encoder")))
    return out


#: each spawned rank: every case of its world, the grad norm's count, the
#: checkpoint across meshes (world 2); it imports torch and repro_torch
_JOB = r"""
import types
import torch
import torch.distributed as dist
import repro_torch.dist.sharding as sharding
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_arch, smoke_config
from repro_torch.core.distributed import CollectiveCount
from repro_torch.dist import Mesh, make_rules
from repro_torch.launch.steps import layout, make_train_step
from repro_torch.models import shard_state_from_numpy
from repro_torch.tree import leaves, unflatten


def state0(p, name, rules):
    s = p["state0"][name]
    ns = types.SimpleNamespace(params=s["params"], opt=types.SimpleNamespace(
        step=s["step"], m=s["m"], v=s["v"]))
    return shard_state_from_numpy(smoke_config(get_arch(name)), ns, rules)


def case(p, name, shape, classical):
    cfg = smoke_config(get_arch(name))
    rules = make_rules(Mesh(("data", "model"), shape), dist.group.WORLD)
    lay = layout(cfg, rules)
    state = state0(p, name, rules)
    count = CollectiveCount()
    step = make_train_step(cfg, rules, remat=name.startswith("mamba2"),
                           sync_every_microbatch=classical, counter=count,
                           **p["kw"])
    out = dict(metrics=[], params=[], m=[], v=[], counts=[],
               n_sharded=lay.n_sharded, n_replicated=lay.n_replicated,
               split=bool(lay.sharded))
    for batch in p["batches"][name]:
        before = dict(vars(count))
        state, m = step(state, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        for k, t in (("params", state.params), ("m", state.opt.m),
                     ("v", state.opt.v)):
            out[k].append([x.clone() for x in leaves(t)])
        out["counts"].append({k: v - before[k]
                              for k, v in vars(count).items()})
    counted = lay.counted()
    mine = torch.tensor(float(sum(lf.numel for lf, c in
                                  zip(lay.leaves, counted) if c)))
    dist.all_reduce(mine)
    out["counted"] = (float(mine), float(sum(
        torch.Size(lf.shape).numel() for lf in lay.leaves)))
    return out


def ckpt(p):
    name = "internlm2-1.8b"
    cfg = smoke_config(get_arch(name))
    fulls = {}
    for shape, save in (((2, 1), True), ((1, 2), False)):
        rules = make_rules(Mesh(("data", "model"), shape), dist.group.WORLD)
        lay = layout(cfg, rules)
        ck = Checkpointer(p["dir"])
        if save:
            state = state0(p, name, rules)
            step = make_train_step(cfg, rules, remat=False, **p["kw"])
            state, _ = step(state, p["batches"][name][0])
            ck.save(1, state, layout=lay, blocking=True)
        else:
            shapes = [lf.local for lf in lay.leaves]
            like = state0(p, name, rules)
            state = unflatten(like, [
                torch.full(s, float("nan"), dtype=t.dtype)
                if t.is_floating_point() else torch.zeros(s, dtype=t.dtype)
                for s, t in zip(shapes + [()] + shapes + shapes,
                                leaves(like))])
            state, at, _ = ck.restore(state, layout=lay)
            assert at == 1
        got = []
        for k, t in (("params", state.params), ("m", state.opt.m),
                     ("v", state.opt.v)):
            for i, x in enumerate(leaves(t)):
                got.append(lay.full_leaf(i, x))
        fulls[shape] = got + [state.opt.step.clone()]
    return fulls


def main(rank, world, p):
    sharding._MIN_SHARD_BYTES_ELEMS = p["min_shard"]
    out = {key: case(p, name, tuple(shape), cl)
           for key, name, shape, cl in p["cases"]}
    if world == 2:
        out["ckpt"] = ckpt(p)
    return out
"""


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's sharded steps for every case: metrics and each device's shard
    of the masters, m and v after every step, the initial states and the
    batches."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jsharding, "_MIN_SHARD_BYTES_ELEMS", MIN_SHARD)
    try:
        ref, states, batches = {}, {}, {}
        for i, name in enumerate(("internlm2-1.8b", "mamba2-780m",
                                  "granite-moe-1b-a400m")):
            states[name] = j_init_train_state(_cfg(name),
                                              jax.random.PRNGKey(0))
            batches[name] = _batches(name, 10 + 10 * i)
        for world, cases in CASES.items():
            for name, (D, M), classical in cases:
                cfg = _cfg(name)
                devices = jax.devices()[:D * M]
                jmesh = JMesh(np.array(devices).reshape(D, M),
                              ("data", "model"))
                jrules = j_make_rules(jmesh)
                st = states[name]
                spec = j_param_specs(st.params, jrules)
                shard = jax.tree.map(lambda s: NamedSharding(jmesh, s), spec,
                                     is_leaf=lambda x: isinstance(x, P))
                rep = NamedSharding(jmesh, P())
                st_sh = type(st)(shard, type(st.opt)(rep, shard, shard))
                st = jax.device_put(st, st_sh)
                where = _where(st.params, devices)
                backend = "pallas" if cfg.family == "moe" else "xla"
                with jregistry.use(backend):
                    jstep = jax.jit(j_make_train_step(
                        cfg, jrules, remat=False,
                        sync_every_microbatch=classical, **KW),
                        out_shardings=(st_sh, rep))
                steps = []
                full = lambda t: [np.asarray(x)   # noqa: E731
                                  for x in jax.tree.leaves(t)]
                p0 = dict(shards=_shards(st.params, devices),
                          full=full(st.params), where=where)
                for b in batches[name]:
                    with jregistry.use(backend):
                        st, m = jstep(st, {k: jax.numpy.asarray(v)
                                           for k, v in b.items()})
                    steps.append(dict(
                        metrics={k: float(v) for k, v in m.items()},
                        params=_shards(st.params, devices),
                        m=_shards(st.opt.m, devices),
                        v=_shards(st.opt.v, devices),
                        full_params=full(st.params), full_v=full(st.opt.v)))
                ref[_key(name, (D, M), classical)] = (p0, steps)
        return ref, {k: _np_state(v) for k, v in states.items()}, batches
    finally:
        mp.undo()


def _spawn(world, jax_ref, tmp):
    _, states, batches = jax_ref
    payload = dict(min_shard=MIN_SHARD, kw=KW, state0=states,
                   batches={k: [{n: torch.from_numpy(a) for n, a in b.items()}
                                for b in v] for k, v in batches.items()},
                   cases=[(_key(n, s, c), n, s, c) for n, s, c in
                          CASES[world]],
                   dir=str(tmp / "ckpt"))
    return spawn_gloo(world, _JOB, payload, tmp / "job", timeout=300)


@pytest.fixture(scope="module")
def world2(jax_ref, tmp_path_factory):
    return _spawn(2, jax_ref, tmp_path_factory.mktemp("fsdp2"))


@pytest.fixture(scope="module")
def world4(jax_ref, tmp_path_factory):
    return _spawn(4, jax_ref, tmp_path_factory.mktemp("fsdp4"))


def _ranks(request, world):
    return request.getfixturevalue(f"world{world}")


def _rel(a, b, base):
    got, want = (a - base).astype(np.float64), (b - base).astype(np.float64)
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def _placed(shards_by_rank, where):
    """Every leaf whole, each rank's shard put where JAX puts the same
    device's."""
    out = []
    for j, (shape, index, _) in enumerate(where):
        a = np.full(shape, np.nan, np.float32)
        for r, idx in enumerate(index):
            a[idx] = shards_by_rank[r][j]
        out.append(a)
    return out


def _per_layer(a, stacked):
    return list(a) if stacked else [a]


ALL = [(w, n, s, c) for w, cases in CASES.items() for n, s, c in cases]


@pytest.mark.parametrize("world,name,shape,classical", ALL,
                         ids=[_key(n, s, c) for _, n, s, c in ALL])
def test_sharded_step_matches_jax_shard_for_shard(request, jax_ref, world,
                                                  name, shape, classical):
    """Every rank: loss and grad norm at SCALAR_RTOL; each master, m and v
    shard of the shape of JAX's shard on the same device, m elementwise at
    GRAD_TOL scaled by 1 - b1. The ranks' shards, placed where JAX places
    the same devices' shards, give whole leaves: each layer's master
    update within UPDATE_RTOL of JAX's and its v within V_RTOL, normwise."""
    ranks = _ranks(request, world)
    key = _key(name, shape, classical)
    p0, steps = jax_ref[0][key]
    m_tol = dict(atol=(1 - ADAM_B1) * GRAD_TOL["atol"],
                 rtol=GRAD_TOL["rtol"])
    for r, out in enumerate(ranks):
        got = out[key]
        for i, want in enumerate(steps):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(
                    got["metrics"][i][k], want["metrics"][k],
                    rtol=SCALAR_RTOL, err_msg=f"{key} rank {r} step {i} {k}")
            np.testing.assert_allclose(got["metrics"][i]["lr"],
                                       want["metrics"]["lr"], rtol=1e-6)
            for j, (a, b) in enumerate(zip(got["m"][i], want["m"][r])):
                assert tuple(a.shape) == b.shape, (key, r, j)
                np.testing.assert_allclose(a.numpy(), b, **m_tol,
                                           err_msg=f"{key} rank {r} m {j}")
            for k in ("params", "v"):
                for j, (a, b) in enumerate(zip(got[k][i], want[k][r])):
                    assert tuple(a.shape) == b.shape, (key, r, k, j)
    where = p0["where"]
    for i, want in enumerate(steps):
        for k, limit in (("params", UPDATE_RTOL), ("v", V_RTOL)):
            port = _placed([[t.numpy() for t in out[key][k][i]]
                            for out in ranks], where)
            for j, (a, b, (_, _, stacked)) in enumerate(zip(
                    port, want[f"full_{k}"], where)):
                base = p0["full"][j] if k == "params" else np.zeros_like(b)
                for layer, (x, y, z) in enumerate(zip(
                        _per_layer(a, stacked), _per_layer(b, stacked),
                        _per_layer(base, stacked))):
                    rel = _rel(x, y, z)
                    assert rel <= limit, (key, i, k, j, layer, rel)


@pytest.mark.parametrize("world,name,shape,classical", ALL,
                         ids=[_key(n, s, c) for _, n, s, c in ALL])
def test_sharded_step_collectives_and_shards(request, jax_ref, world, name,
                                             shape, classical):
    """A CA step: one all_gather of the data-split shards and ca_k
    reduce_scatters of their gradients, one slot a data rank each (neither
    when no leaf is split), one all_reduce of the replicated leaves'
    gradients and the loss over the data group, and one of the squared
    norm; classical: each a microbatch. No rank holds a full copy of a
    leaf JAX shards."""
    ranks = _ranks(request, world)
    key = _key(name, shape, classical)
    p0, _ = jax_ref[0][key]
    D = shape[0]
    per = CA_K if classical else 1
    for r, out in enumerate(ranks):
        got = out[key]
        split = int(got["split"])
        want = dict(all_gathers=per * split, reduce_scatters=CA_K * split,
                    all_reduces=2 * per)
        want["words"] = ((per + CA_K) * split * D * got["n_sharded"]
                         + per * (got["n_replicated"] + 2))
        for counts in got["counts"]:
            assert counts == want, (key, r, counts)
        full = [tuple(t.shape) for t in
                jax.tree.leaves(jax_ref[1][name]["params"])]
        small = [a.shape != f for a, f in zip(got["params"][0], full)]
        sharded = [b.shape != f for b, f in zip(p0["shards"][r], full)]
        assert small == sharded and any(sharded), (key, r)


@pytest.mark.parametrize("world,shape", [(2, (2, 1)), (2, (1, 2)),
                                         (4, (2, 2))])
def test_grad_norm_counts_a_replicated_leaf_once(request, world, shape):
    """Summed over the ranks, the elements each rank counts in the grad
    norm are the tree's elements: a leaf replicated over an axis counts on
    that axis's index 0 alone."""
    ranks = _ranks(request, world)
    key = _key("internlm2-1.8b", shape, False)
    for out in ranks:
        counted, total = out[key]["counted"]
        assert counted == total


def test_checkpoint_written_at_one_mesh_restores_at_another(world2):
    """The state after one step at (2, 1), saved as global leaves, restored
    into the (1, 2) layout: every leaf, gathered whole, bitwise the saved
    one, and the step."""
    saved, restored = world2[0]["ckpt"][(2, 1)], world2[0]["ckpt"][(1, 2)]
    assert len(saved) == len(restored)
    for a, b in zip(saved, restored):
        assert torch.equal(a, b)
    assert world2[1]["ckpt"][(1, 2)][0] is None     # rank 0 gathers


# ------------------------------------------------------ shape logic ---
PROD = {"pod": ((16, 16), ("data", "model"), (2, 4)),
        "multipod": ((2, 16, 16), ("pod", "data", "model"), (2, 2, 2))}


def _slice_pairs(shape, index):
    return [(0, d) if s.start is None else (s.start, s.stop)
            for s, d in zip(index, shape)]


@pytest.mark.parametrize("mesh_name", sorted(PROD))
@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_shard_shape_and_slice_equal_named_sharding(name, mesh_name):
    """Every leaf of every full config (meta tensors, JAX's by
    ``eval_shape``): ``shard_shape`` equal to ``NamedSharding
    .shard_shape`` at the production mesh, and ``shard_slice`` at each
    rank equal to ``devices_indices_map`` at device r of a host mesh of the
    same axes (8 spoofed devices)."""
    prod, names, host = PROD[mesh_name]
    jcfg = jconfigs.get_arch(name)
    sds = jax.eval_shape(lambda k: j_init_params(jcfg, k),
                         jax.ShapeDtypeStruct((2,), np.uint32))
    shapes = [tuple(t.shape) for t in jax.tree.leaves(sds)]
    for mshape in (prod, host):
        if mshape is prod:
            jmesh = spoof_mesh(prod, names)
        else:
            devs = jax.devices()[:int(np.prod(host))]
            jmesh = JMesh(np.array(devs).reshape(host), names)
        mesh = Mesh(names, mshape)
        rules = make_rules(mesh)
        specs = jax.tree.leaves(j_param_specs(sds, j_make_rules(jmesh)),
                                is_leaf=lambda x: isinstance(x, P))
        for shape, spec in zip(shapes, specs):
            ns = NamedSharding(jmesh, spec)
            assert shard_shape(shape, tuple(spec), rules.mesh) == \
                ns.shard_shape(shape), (name, shape, spec)
            if mshape is host:
                index = ns.devices_indices_map(shape)
                for r, d in enumerate(jmesh.devices.flat):
                    got = shard_slice(shape, tuple(spec), mesh,
                                      shard_coords(rules, r))
                    assert [(s.start, s.stop) for s in got] == \
                        _slice_pairs(shape, index[d]), (name, spec, r)


def test_host_and_production_meshes_match_jax():
    """``make_host_mesh``: the model axis 4, 2 or 1, the first dividing
    the devices (``repro.launch.mesh.make_host_mesh``'s rule), data-only
    for a family without tensor parallelism; the production shapes."""
    for n, want in ((1, (1, 1)), (2, (1, 2)), (3, (3, 1)), (4, (1, 4)),
                    (6, (3, 2)), (8, (2, 4)), (12, (3, 4))):
        assert tmesh.make_host_mesh(n).sizes == want
        assert tmesh.make_host_mesh(n, tensor_parallel=False).sizes == (n, 1)
    assert tmesh.make_production_mesh() == Mesh(("data", "model"), (16, 16))
    assert tmesh.make_production_mesh(multi_pod=True) == Mesh(
        ("pod", "data", "model"), (2, 16, 16))


# ------------------------------------------------- in this process ---
@pytest.fixture
def group_of_one():
    tmesh.init("cpu", rank=0, world_size=1)
    try:
        yield
    finally:
        tmesh.shutdown()


@pytest.mark.parametrize("classical", [False, True], ids=["ca2", "classical"])
def test_mesh_of_one_is_bitwise_the_single_device_step(group_of_one,
                                                       classical):
    """(data, model) = (1, 1) in a gloo group of one: two steps leave every
    master, moment and metric bitwise the single-device step's (its tree
    stacked as JAX's), with two all-reduces a step (or a microbatch) and,
    every leaf whole, no gather or reduce-scatter."""
    from repro_torch.core.distributed import CollectiveCount
    from repro_torch.launch.steps import shard_train_state
    cfg = _cfg("internlm2-1.8b")
    tcfg = to_torch_config_arch(cfg)
    jstate = jax.tree.map(np.asarray,
                          j_init_train_state(cfg, jax.random.PRNGKey(0)))
    rules = make_rules(Mesh(("data", "model"), (1, 1)),
                       torch.distributed.group.WORLD)
    count = CollectiveCount()
    runs = []
    for r in (rules, None):
        state = train_state_from_numpy(tcfg, jstate)
        if r is not None:
            state = shard_train_state(tcfg, state, r)
        step = make_train_step(tcfg, r, remat=False, counter=count,
                               sync_every_microbatch=classical, **KW)
        ms = []
        for b in _batches("internlm2-1.8b", 30):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            ms.append(m)
        runs.append((state, ms))
    n = CA_K if classical else 1
    assert (count.all_gathers, count.reduce_scatters, count.all_reduces) == \
        (0, 0, 2 * STEPS * n)
    (a, ma), (b, mb) = runs
    b = shard_train_state(tcfg, b, rules)        # stacked, a copy
    for x, y in zip(leaves(list(a)), leaves(list(b))):
        assert torch.equal(x, y)
    for x, y in zip(ma, mb):
        assert all(torch.equal(x[k], y[k]) for k in x)


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "mamba2-780m",
                                  "zamba2-2.7b", "whisper-medium",
                                  "qwen2-vl-2b"])
def test_other_families_raise_for_a_model_axis(name):
    """Tensor parallelism is the dense family's: the others raise, naming
    the ROADMAP item, for a model axis past 1, and build on a data-only
    mesh."""
    cfg = get_arch(name)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        make_train_step(cfg, make_rules(Mesh(("data", "model"), (2, 2))))
    lay = layout(cfg, make_rules(Mesh(("data", "model"), (4, 1))))
    assert lay.n_sharded > 0


def test_init_train_state_shards_what_one_device_draws(group_of_one):
    """``init_train_state(..., rules)`` at (1, 1): the single device's
    weights, stacked, and zero moments at step 0."""
    from repro_torch.launch.steps import shard_train_state
    tcfg = to_torch_config_arch(_cfg("internlm2-1.8b"))
    rules = make_rules(Mesh(("data", "model"), (1, 1)),
                       torch.distributed.group.WORLD)
    got = init_train_state(tcfg, torch.Generator().manual_seed(0),
                           device="cpu", rules=rules)
    want = shard_train_state(tcfg, init_train_state(
        tcfg, torch.Generator().manual_seed(0), device="cpu"), rules)
    for x, y in zip(leaves(list(got)), leaves(list(want))):
        assert torch.equal(x, y)


def test_rules_with_no_group_are_one_device_in_both_entry_points():
    """Rules with no process group: at one device ``init_train_state`` and
    ``shard_train_state`` give the port's tree, which ``make_train_step``
    with the same rules trains bitwise as with no rules; on a mesh of more
    devices all three raise."""
    from repro_torch.launch.steps import shard_train_state
    tcfg = to_torch_config_arch(_cfg("internlm2-1.8b"))
    one = make_rules(Mesh(("data", "model"), (1, 1)))
    runs = []
    for rules in (one, None):
        state = init_train_state(tcfg, torch.Generator().manual_seed(0),
                                 device="cpu", rules=rules)
        state = shard_train_state(tcfg, state, rules)
        step = make_train_step(tcfg, rules, remat=False, **KW)
        for b in _batches("internlm2-1.8b", 40):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        runs.append((state, m))
    (a, ma), (b, mb) = runs
    for x, y in zip(leaves(list(a)), leaves(list(b))):
        assert torch.equal(x, y)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    four = make_rules(Mesh(("data", "model"), (4, 1)))
    for call in (lambda: init_train_state(tcfg, torch.Generator(),
                                          device="cpu", rules=four),
                 lambda: shard_train_state(tcfg, a, four),
                 lambda: make_train_step(tcfg, four)):
        with pytest.raises(ValueError, match="no process group"):
            call()

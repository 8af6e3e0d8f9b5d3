"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: its
active-parameter count against the JAX dry run's, cells of every family
traced under fake tensors in a fake process group (rank 0's shards, the
item-7 refusals), the fake group gone after each cell, and the CUDA impls'
refusal of a real CPU tensor kept."""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as J_ARCHS
from repro.models import init_params as j_init_params
from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, smoke_config
from repro_torch.dist import Mesh, make_rules, sharding
from repro_torch.kernels import registry
from repro_torch.launch import dryrun
from repro_torch.launch.steps import layout
from repro_torch.models import init_params

FAMILIES = {"dense": "internlm2-1.8b", "moe": "granite-moe-1b-a400m",
            "ssm": "mamba2-780m", "hybrid": "zamba2-2.7b",
            "audio": "whisper-medium", "vlm": "qwen2-vl-2b"}


def _jax_active_params():
    """``repro.launch.dryrun._active_params``, compiled from its source:
    importing that module sets XLA_FLAGS to 512 host devices for this
    process and every process it starts."""
    path = Path(__file__).resolve().parents[1] / "src/repro/launch/dryrun.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "_active_params")
    ns = {}
    exec(compile(ast.Module([fn], []), str(path), "exec"), ns)
    return ns["_active_params"]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_active_params_match_jax(arch):
    sds = jax.eval_shape(lambda k: j_init_params(J_ARCHS[arch], k),
                         jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = _jax_active_params()(J_ARCHS[arch], sds)
    got = dryrun.active_params(ARCHS[arch],
                               init_params(ARCHS[arch], None, device="meta"))
    assert got == want


def _shape(world: int) -> ShapeConfig:
    """A train cell of two microbatches of one row a data rank."""
    return ShapeConfig("train_tiny", 16, 2 * world, "train")


def _cell(family, sizes, monkeypatch):
    # shard the smoke widths' leaves (the fsdp tests do the same)
    monkeypatch.setattr(sharding, "_MIN_SHARD_BYTES_ELEMS", 128)
    cfg = smoke_config(ARCHS[FAMILIES[family]])
    mesh = Mesh(("data", "model"), sizes)
    rec = dryrun.run_cell(cfg.name, _shape(sizes[0]), mesh, ca_k=2, cfg=cfg)
    assert not dist.is_initialized()          # the fake group is gone
    return cfg, mesh, rec


CELLS = [(f, (1, 1)) for f in FAMILIES] + [(f, (2, 1)) for f in FAMILIES] \
    + [("dense", (1, 2)), ("dense", (2, 2))]


@pytest.mark.parametrize("family,sizes", CELLS,
                         ids=[f"{f}-{d}x{m}" for f, (d, m) in CELLS])
def test_smoke_cell_traces_rank0_shards(family, sizes, monkeypatch):
    cfg, mesh, rec = _cell(family, sizes, monkeypatch)
    assert rec["status"] == "ok", rec
    # rank 0's float32 masters are the layout's shards
    assert rec["shard_bytes"] == layout(cfg, make_rules(mesh)).shard_bytes()
    split = rec["peak_split_bytes"]
    assert rec["peak_bytes"] == sum(split.values())
    assert split["state"] >= 3 * rec["shard_bytes"]  # masters, m and v
    assert rec["fits"] is True and not rec["uncertain"]
    roof = rec["roofline"]
    assert roof["flops"] > 0 and roof["bytes_hbm"] > 0
    # the model's attention or scan ran its CUDA wrappers (no launch)
    assert roof["registry_ops"]
    assert set(roof["registry_ops"]) <= {"flash_attention", "flash_dq",
                                         "flash_dkv", "ssd", "ssd_bwd"}
    world = sizes[0] * sizes[1]
    kinds = {k.split("/")[0] for k in roof["collective_detail"]}
    assert "all_reduce" in kinds          # the sharded step, at world 1 too
    assert (roof["t_collective"] > 0) == (world > 1)
    if sizes[0] > 1:
        assert {"all_gather", "reduce_scatter"} <= kinds


def test_nondense_family_at_model_axis_is_unsupported(monkeypatch):
    _, _, rec = _cell("moe", (1, 2), monkeypatch)
    assert rec["status"] == "unsupported"
    assert "item 7" in rec["reason"]


def test_serving_on_a_mesh_is_unsupported():
    """Sharded serving (ROADMAP queue 1 item 7(b)) is done on the model
    axis for the dense family: internlm2's decode at (2, 1), each rank its
    batch rows, is ``ok``; another family's serving cell on a model axis
    past 1 stays ``unsupported``, naming item 7(a)."""
    cfg = smoke_config(ARCHS["internlm2-1.8b"])
    shape = ShapeConfig("decode_tiny", 32, 2, "decode")
    rec = dryrun.run_cell(cfg.name, shape, Mesh(("data", "model"), (2, 1)),
                          cfg=cfg)
    assert rec["status"] == "ok", rec
    assert not dist.is_initialized()
    moe = smoke_config(ARCHS["granite-moe-1b-a400m"])
    rec = dryrun.run_cell(moe.name, shape, Mesh(("data", "model"), (1, 2)),
                          cfg=moe)
    assert rec["status"] == "unsupported"
    assert "queue 1 item 7(a)" in rec["reason"]
    assert not dist.is_initialized()


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("sizes", [(1, 2), (1, 4), (2, 2)])
def test_dense_serving_cell_traces_rank0s_share(kind, sizes, monkeypatch):
    """A dense serving cell on a mesh traces rank 0's program: its
    tensor-parallel weight shards (the compute copy's layout), its rows of
    the batch and of every slot (``cache_shard``), the model axis's
    collectives (decode: the (o, lse) gather a layer among them)."""
    monkeypatch.setattr(sharding, "_MIN_SHARD_BYTES_ELEMS", 128)
    cfg = smoke_config(ARCHS["internlm2-1.8b"])
    mesh = Mesh(("data", "model"), sizes)
    shape = ShapeConfig(kind, 64, 4, kind)
    rec = dryrun.run_cell(cfg.name, shape, mesh, cfg=cfg)
    assert rec["status"] == "ok", rec
    lay = layout(cfg, make_rules(mesh))
    assert rec["shard_bytes"] == 2 * sum(lf.gnumel for lf in lay.leaves)
    one = dryrun.run_cell(cfg.name, shape, None, cfg=cfg)
    assert rec["peak_bytes"] < one["peak_bytes"]
    assert rec["roofline"]["registry_ops"] == one["roofline"][
        "registry_ops"]
    kinds = {k.split("/")[0] for k in rec["roofline"]["collective_detail"]}
    assert {"all_gather", "all_reduce"} <= kinds
    assert not dist.is_initialized()


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_cell_on_one_card(kind):
    cfg = smoke_config(ARCHS["internlm2-1.8b"])
    rec = dryrun.run_cell(cfg.name, ShapeConfig(kind, 32, 2, kind), None,
                          cfg=cfg)
    assert rec["status"] == "ok", rec
    assert rec["roofline"]["registry_ops"] == {
        "prefill": {"flash_attention": cfg.n_layers},
        "decode": {"paged_attention": cfg.n_layers}}[kind]


def test_skipped_cell_keeps_jax_reason():
    rec = dryrun.run_cell("llama3-8b", SHAPES["long_500k"], None)
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]


def test_cuda_impl_still_refuses_a_real_cpu_tensor():
    q = torch.zeros(1, 4, 2, 16)
    with registry.use("cuda"), pytest.raises(RuntimeError,
                                             match="cannot run"):
        registry.dispatch("flash_attention", q, q, q)


@pytest.mark.parametrize("sizes", [None, (2, 1)],
                         ids=["single", "2x1"])
def test_peak_split_by_what_allocates(sizes, monkeypatch):
    """The split at the peak comes from the allocating code's own tags
    (``roofline.category``): rank 0's state, the bf16 compute copy, and at
    the peak (the first reduce-scatter's receive slot; at one device the
    accumulation) the float32 accumulator with the collectives' staging
    buffers; the rest is the model's, its gradients among it."""
    monkeypatch.setattr(sharding, "_MIN_SHARD_BYTES_ELEMS", 128)
    cfg = smoke_config(ARCHS["internlm2-1.8b"])
    world = 1 if sizes is None else sizes[0]
    mesh = None if sizes is None else Mesh(("data", "model"), sizes)
    shape = _shape(world)
    rec = dryrun.run_cell(cfg.name, shape, mesh, ca_k=2, cfg=cfg)
    assert rec["status"] == "ok", rec
    split = rec["peak_split_bytes"]
    batch = 2 * shape.global_batch * shape.seq_len * 4   # tokens, labels
    assert split["state"] == 3 * rec["shard_bytes"] + batch + 4  # + step
    if sizes is None:
        n = rec["shard_bytes"] // 4
        assert split["compute_copy"] == 2 * n
        assert split["accumulator_staging"] == 4 * n + 4    # + the loss
    else:
        lay = layout(cfg, make_rules(mesh))
        ns, nr = lay.n_sharded, lay.n_replicated
        assert split["compute_copy"] == 2 * sum(lf.gnumel
                                                for lf in lay.leaves)
        # the sharded accumulator, the replicated leaves' buffer (and the
        # loss), the bf16 send buffer and its receive slot
        assert split["accumulator_staging"] == \
            4 * ns + 4 * (nr + 1) + 2 * world * ns + 2 * ns
        # the microbatch's bf16 gradients, which the reduce-scatter's
        # caller still holds (ROADMAP queue 1 item 7(c))
        assert split["activations_temporaries"] >= split["compute_copy"]
    assert rec["peak_bytes"] == sum(split.values())


def test_only_the_ports_refusal_is_unsupported(monkeypatch):
    """A cell whose trace raises ``repro_torch.Unsupported`` is
    ``unsupported``; any other ``NotImplementedError`` (an op with no fake
    kernel, an op with no ``cuda`` impl) is an error."""
    from repro_torch import Unsupported
    cfg = smoke_config(ARCHS["internlm2-1.8b"])

    def raising(exc):
        def trace(*_a, **_k):
            raise exc
        return trace
    monkeypatch.setattr(dryrun, "_trace", raising(
        NotImplementedError("aten::foo: no fake impl")))
    rec = dryrun.run_cell(cfg.name, _shape(1), None, cfg=cfg)
    assert rec["status"] == "error"
    assert "aten::foo" in rec["error"]
    monkeypatch.setattr(dryrun, "_trace", raising(
        Unsupported("sharded serving is ROADMAP queue 1 item 7(b)")))
    rec = dryrun.run_cell(cfg.name, _shape(1), None, cfg=cfg)
    assert rec["status"] == "unsupported" and "7(b)" in rec["reason"]


def test_fits_leaves_the_allocators_slack():
    """``fits`` needs the peak, the context and ``SLACK_BYTES`` within the
    card; a cell whose peak and context fit without the slack is
    ``uncertain``; one past the card does not fit."""
    from repro_torch.roofline import H100
    cfg = smoke_config(ARCHS["internlm2-1.8b"])
    rec = dryrun.run_cell(cfg.name, _shape(1), None, ca_k=2, cfg=cfg)
    need = rec["needs_bytes"]
    assert need == rec["peak_bytes"] + H100.context_bytes
    assert (rec["fits"], rec["uncertain"]) == dryrun.fit_verdict(
        need, H100.hbm_bytes) == (True, False)
    slack = dryrun.SLACK_BYTES
    for cap, verdict in ((need + slack, (True, False)),
                         (need + slack - 1, (False, True)),
                         (need, (False, True)), (need - 1, (False, False))):
        assert dryrun.fit_verdict(need, cap) == verdict, cap

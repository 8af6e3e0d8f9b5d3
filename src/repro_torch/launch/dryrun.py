"""Dry run: every (arch x shape x mesh) cell's per-card memory and roofline
on a host with no card (the counterpart of ``repro.launch.dryrun``, which
compiles each cell for 512 spoofed TPU devices and reads XLA's
``memory_analysis``).

An eager program has no compiled module, so each cell runs rank 0's
program once, with nothing computed:

* under ``FakeTensorMode`` (tensors with shapes and no memory; they sit on
  the CPU device, standing for the card's: autograd over fake ``cuda``
  tensors aborts in a build of PyTorch without CUDA), the registry's
  ``cuda`` impls selected, whose wrappers allocate their outputs and
  workspaces as on the card and launch nothing (``kernels._build.launch``);
* in a ``fake`` process group the size of the mesh (collectives that move
  nothing), torn down after the cell;
* through the port's entry points: ``launch.steps.make_train_step(cfg,
  make_rules(mesh, group))`` on rank 0's shards for a train cell (the
  single-device step for ``--mesh single``), the forward with
  ``last_only`` for prefill, ``make_serve_step(cfg, rules)`` over
  ``init_cache`` for decode, each row at its own position as the engine
  decodes; a serving cell on a mesh runs rank 0's share: its batch rows
  (the data axes), its weights (``launch.steps.serve_params``: the dense
  family's tensor-parallel shards on a model axis past 1) and its shard
  of the cache (``dist.sharding.cache_shard``: its rows of every slot);
* under ``roofline.analyze`` with a ``StorageTracker``: the peak of live
  storage bytes a card (what ``torch.cuda.max_memory_allocated`` counts),
  split into state shards, the compute copy, accumulator and staging
  buffers, and activations with temporaries; the FLOPs, HBM bytes,
  collective bytes and the three roofline terms.

``fits``: the peak plus the memory a rank's CUDA context and NCCL take
outside PyTorch's allocator (``H100.context_bytes``) plus
``SLACK_BYTES`` within the card's capacity (``H100.hbm_bytes``). Live
bytes are not all a card needs: its caching allocator keeps blocks that
earlier, smaller tensors split, which a large request cannot use. A cell
whose peak and context fit but not with the slack is ``uncertain``
(``fits`` False, ``uncertain`` True). ``large_allocations`` lists the
program's allocations of 1 GiB or more, each with the live bytes before
it.

A cell is ``ok``, ``skipped`` (JAX's ``cell_applicable``),
``unsupported`` (a ``repro_torch.Unsupported``, the port's own refusal:
tensor parallelism outside the dense family, for training and serving,
and a training step whose kv heads do not divide the model axis, ROADMAP
queue 1 item 7(a)) or ``error`` (any other exception); the run exits 1 on
an error, as JAX's does.

Usage (CPU; no card):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --mesh 4,1 --batch 32 --seq 1024 --ca-k 4
Results accumulate into ``--out`` (default results/dryrun_torch.json).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
import warnings
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import Unsupported, roofline
from repro_torch.configs import (ARCHS, SHAPES, ShapeConfig, cell_applicable,
                                 get_arch)
from repro_torch.dist import Mesh, fit_spec, make_rules, shard_shape
from repro_torch.kernels import registry
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import TrainState, layout, make_serve_step, \
    make_train_step
from repro_torch.models import forward, init_cache, init_params, tp
from repro_torch.optim import adamw_init
from repro_torch.roofline import H100
from repro_torch.serve.cache import local_cache
from repro_torch.tree import leaves, tree_map

#: the meshes the port runs on four cards, beside JAX's production ones
FOUR_CARD_MESHES = ((4, 1), (2, 2), (1, 4))

#: bytes the caching allocator held reserved and unusable, in blocks split
#: by earlier tensors (``inactive_split_bytes``), when llama3-8b's sharded
#: step at (4, 1), batch 32 x 1,024, ca_k 4, ran out of memory on an
#: NVIDIA H100 80GB HBM3 at 700 W (tools/dp_step_time.py, rank 0): the
#: margin a cell's live bytes and context must leave to be sure to fit
SLACK_BYTES = 9_524_918_272


def active_params(cfg, params) -> int:
    """Parameters a token touches (``repro.launch.dryrun._active_params``):
    every leaf but the embedding table, an MoE layer's routed experts
    scaled by top_k / E, plus the tied embedding's use as the output
    projection."""
    total = 0

    def walk(sub, keys):
        nonlocal total
        if isinstance(sub, dict):
            for k, v in sub.items():
                walk(v, keys + [k])
        elif isinstance(sub, list):
            for v in sub:
                walk(v, keys)
        else:
            if keys and keys[-1] == "embed":
                return
            n = sub.numel()
            if "moe" in keys and "shared" not in keys \
                    and keys[-1] != "router":
                n = int(n * cfg.top_k / max(cfg.n_experts, 1))
            total += n
    walk(params, [])
    if cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab
    return total


def fit_verdict(need: float, capacity: float) -> tuple:
    """(fits, uncertain) of a cell that needs ``need`` bytes a card (its
    peak and the context) on a card of ``capacity``: it fits when the
    allocator's ``SLACK_BYTES`` fit too, and is uncertain when only the
    live bytes do."""
    fits = need + SLACK_BYTES <= capacity
    return fits, not fits and need <= capacity


def mesh_name(mesh: Optional[Mesh]) -> str:
    return "single" if mesh is None else "x".join(map(str, mesh.sizes))


def parse_mesh(text: str) -> Optional[Mesh]:
    """``single`` (one card, no process group), ``D,M`` or ``P,D,M``."""
    if text == "single":
        return None
    sizes = tuple(int(v) for v in text.split(","))
    names = ("data", "model") if len(sizes) == 2 else ("pod", "data", "model")
    return Mesh(names, sizes)


def batch_for(cfg, shape: ShapeConfig) -> dict:
    """The cell's inputs, as ``repro.configs.input_specs`` makes them (fake
    tensors under the caller's mode)."""
    B, S, i32 = shape.global_batch, shape.seq_len, torch.int32
    if shape.kind == "decode":
        return dict(tokens=torch.zeros(B, 1, dtype=i32))
    train = shape.kind == "train"

    def tok(n):
        out = dict(tokens=torch.zeros(B, n, dtype=i32))
        if train:
            out["labels"] = torch.zeros(B, n, dtype=i32)
        return out
    if cfg.family == "audio":
        return dict(enc_embeds=torch.zeros(B, S, cfg.d_model,
                                           dtype=torch.bfloat16),
                    **tok(cfg.dec_len))
    if cfg.family == "vlm":
        return dict(vision_embeds=torch.zeros(B, cfg.vision_patches,
                                              cfg.d_model,
                                              dtype=torch.bfloat16),
                    **tok(S - cfg.vision_patches))
    return tok(S)


@contextlib.contextmanager
def fake_group(world: int):
    """A default ``fake`` process group of ``world`` ranks, this process
    rank 0, destroyed on exit (also on an exception)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dry run: this process is already in a process "
                           "group; run the dry run in one that is not")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _trace(cfg, shape: ShapeConfig, rules, ca_k: int):
    """Rank 0's program of the cell under fake tensors: its Roofline, and
    the bytes of the parameters rank 0 holds (its float32 masters' shards
    for a train cell)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    tracker = roofline.StorageTracker()
    with FakeTensorMode(), registry.use("cuda"):
        batch = batch_for(cfg, shape)
        if shape.kind == "train":
            step = make_train_step(cfg, rules, ca_k=ca_k, remat=True)
            if rules is None:
                params = tree_map(lambda t: torch.zeros(t.shape,
                                                        dtype=t.dtype),
                                  init_params(cfg, None, device="meta"))
            else:
                lay = layout(cfg, rules)
                params = lay.tree([torch.zeros(lf.local, dtype=torch.float32)
                                   for lf in lay.leaves])
            state = TrainState(params, adamw_init(params))
            weights = leaves(state.params)
            held = weights + leaves(state.opt.m) + \
                leaves(state.opt.v) + [state.opt.step]
            fn, args = step, (state, batch)
        else:
            # prefill and decode both serve, rank 0 its share of the mesh
            serve = make_serve_step(cfg, rules, kv_rows=shape.seq_len)
            params, weights = _serve_weights(cfg, rules)
            held = list(weights)
            B = shape.global_batch
            if rules is not None:
                B = shard_shape((B,), fit_spec((rules.dp,), (B,),
                                               rules.mesh), rules.mesh)[0]
                batch = {k: v[:B] for k, v in batch.items()}
            if shape.kind == "prefill":
                def fn(params, batch):
                    with torch.no_grad():
                        return forward(params, cfg, batch, last_only=True)
                args = (params, batch)
            else:
                cache = local_cache(
                    init_cache(cfg, shape.global_batch, shape.seq_len,
                               device="meta",
                               enc_len=(shape.seq_len if cfg.family ==
                                        "audio" else None)), rules)
                held += leaves(cache)

                # the engine's decode: each row at its own position, the
                # slot cache read through the paged_attention op
                pos = torch.full((B,), shape.seq_len - 1, dtype=torch.int32)

                def fn(params, cache, tokens, pos):
                    with torch.no_grad():
                        return serve(params, cache, tokens, positions=pos)
                args = (params, cache, batch["tokens"], pos)
        for t in held + list(batch.values()):
            tracker.add(t, "state")
        pbytes = sum(t.numel() * t.element_size() for t in weights)
        return roofline.analyze(fn, *args, tracker=tracker), pbytes


def _serve_weights(cfg, rules):
    """Rank 0's bf16 serving weights (fake tensors) and the plain tensors
    that hold them: the whole tree on one device or a data-only mesh, the
    tensor-parallel shards (``launch.steps.serve_params``'s layout) as
    DTensors on a model axis past 1."""
    meta = init_params(cfg, None, dtype=torch.bfloat16, device="meta")
    if rules is None or rules.tp_size == 1:
        params = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                          meta)
        return params, leaves(params)
    lay = layout(cfg, rules, training=False)
    shards = [torch.zeros(lf.glocal, dtype=torch.bfloat16)
              for lf in lay.leaves]
    return lay.unstack(shards, tp.wrapper(rules.tp_mesh)), shards



def run_cell(arch: str, shape: ShapeConfig, mesh: Optional[Mesh],
             ca_k: int = 8, chip=H100, cfg=None) -> dict:
    """One cell's record (see the module docstring); ``cfg`` in place of
    ``arch``'s published config (a smoke config)."""
    cfg = cfg or get_arch(arch)
    rec = dict(arch=arch, shape=shape.name, mesh=mesh_name(mesh),
               kind=shape.kind, batch=[shape.global_batch, shape.seq_len],
               ca_k=ca_k if shape.kind == "train" else None)
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        return dict(rec, status="skipped", reason=reason)
    n_dev = 1 if mesh is None else math.prod(mesh.sizes)
    rec["n_active_params"] = active_params(
        cfg, init_params(cfg, None, device="meta"))
    t0 = time.time()
    try:
        with warnings.catch_warnings():
            # fake tensors' data pointers are read (as 0) by the wrappers
            warnings.simplefilter("ignore")
            group = fake_group(n_dev) if mesh is not None \
                else contextlib.nullcontext()
            with group as g:
                rules = make_rules(mesh, g) if mesh is not None else None
                roof, pbytes = _trace(cfg, shape, rules, ca_k)
    except Unsupported as e:
        # the port's own refusal (ROADMAP queue 1 item 7); a
        # NotImplementedError of PyTorch's or the registry's is an error
        return dict(rec, status="unsupported", reason=str(e))
    except Exception as e:     # a cell that fails is reported, not fatal
        traceback.print_exc()
        return dict(rec, status="error", error=f"{type(e).__name__}: {e}")
    mem = roof.per_device_memory
    need = mem["peak_live_bytes"] + chip.context_bytes
    fits, uncertain = fit_verdict(need, chip.hbm_bytes)
    mf = roofline.model_flops(cfg, shape, rec["n_active_params"], shape.kind)
    return dict(rec, status="ok", t_trace_s=round(time.time() - t0, 1),
                peak_bytes=mem["peak_live_bytes"],
                peak_gib=mem["peak_live_bytes"] / 2 ** 30,
                peak_split_bytes=mem["at_peak"], shard_bytes=pbytes,
                needs_bytes=need, capacity_bytes=chip.hbm_bytes,
                fits=fits, uncertain=uncertain,
                large_allocations=mem["large_allocations"],
                roofline=roof.as_dict(), model_flops_total=mf,
                model_flops_per_device=mf / n_dev,
                useful_flop_ratio=(mf / n_dev) / max(roof.flops, 1.0))


def cells(args) -> list:
    """(arch, ShapeConfig, mesh) of the run, in order."""
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES.values()) if (args.all or not args.shape) \
        else [SHAPES[args.shape]]
    if args.batch or args.seq:
        shapes = [ShapeConfig(f"{s.name}_b{args.batch or s.global_batch}"
                              f"_s{args.seq or s.seq_len}",
                              args.seq or s.seq_len,
                              args.batch or s.global_batch, s.kind)
                  for s in shapes]
    if args.mesh:
        meshes = [parse_mesh(args.mesh)]
    else:
        pods = {"on": [True], "off": [False],
                "both": [False, True]}[args.multi_pod]
        meshes = [make_production_mesh(multi_pod=p) for p in pods]
        meshes += [Mesh(("data", "model"), m) for m in FOUR_CARD_MESHES]
    return [(a, s, m) for a in archs for s in shapes for m in meshes]


def _line(rec: dict) -> str:
    head = f"{rec['status'].upper():11s} {rec['arch']:22s} " \
        f"{rec['shape']:22s} {rec['mesh']:8s}"
    if rec["status"] == "ok":
        r = rec["roofline"]
        split = {k: round(v / 2 ** 30, 2)
                 for k, v in rec["peak_split_bytes"].items()}
        return (f"{head} peak {rec['peak_gib']:.2f} GiB a card {split} "
                f"fits={'uncertain' if rec.get('uncertain') else rec['fits']} "
                f"bottleneck={r['bottleneck']} "
                f"t_compute={r['t_compute']:.4g}s "
                f"t_memory={r['t_memory']:.4g}s "
                f"t_collective={r['t_collective']:.4g}s "
                f"({rec['t_trace_s']}s traced)")
    return f"{head} {rec.get('reason') or rec.get('error')}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="single, D,M or P,D,M (default: JAX's production "
                    "meshes by --multi-pod, then (4, 1), (2, 2), (1, 4))")
    ap.add_argument("--multi-pod", choices=["on", "off", "both"],
                    default="both")
    ap.add_argument("--batch", type=int, default=None,
                    help="a cell's global batch")
    ap.add_argument("--seq", type=int, default=None,
                    help="a cell's sequence length (a decode cell's "
                    "cache depth)")
    ap.add_argument("--ca-k", type=int, default=8)
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--force", action="store_true",
                    help="rerun cells the output already holds")
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    results = json.loads(out.read_text()) if out.exists() else {}
    for arch, shape, mesh in cells(args):
        key = f"{arch}|{shape.name}|{mesh_name(mesh)}|ca_k={args.ca_k}"
        if key in results and not args.force and \
                results[key]["status"] != "error":
            print(_line(results[key]), "(kept)", flush=True)
            continue
        results[key] = run_cell(arch, shape, mesh, args.ca_k)
        print(_line(results[key]), flush=True)
        out.write_text(json.dumps(results, indent=1))
    counts = {s: sum(r["status"] == s for r in results.values())
              for s in ("ok", "skipped", "unsupported", "error")}
    print(f"\ndry run: {counts['ok']} ok, {counts['skipped']} skipped, "
          f"{counts['unsupported']} unsupported, {counts['error']} errors "
          f"({out})")
    return 1 if counts["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())

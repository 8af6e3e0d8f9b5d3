"""Time the sharded CA train step on the cards of one host (or CPU ranks),
one process a rank, on a (data, model) mesh.

  torchrun --nproc-per-node 4 tools/dp_step_time.py --arch llama3-8b \\
      --mesh 1,4
  torchrun --nproc-per-node 4 tools/dp_step_time.py --mesh 2,2
  python tools/dp_step_time.py --mesh single       # one card, unsharded
  torchrun --nproc-per-node 2 tools/dp_step_time.py --device cpu \\
      --preset tiny --mesh 2,1

Every rank takes its part of the same global batches (``TokenStream(8
ca_k, 1024)``, seed 0, at the full preset: JAX's preset, phase 11's for
internlm2) and runs ``make_train_step(cfg, rules)`` on the rules of
``--mesh`` over the default group (``single``: ``rules=None`` in one
process) from ``init_train_state`` with a generator seeded 0, so every
mesh starts from the same weights: a warm-up step (its model-axis
collectives counted by DTensor's ``CommDebugMode``), then three timed
steps, each between two synchronizes. Rank 0 prints the cards' names and
power limits, the mesh, each rank's shard bytes, ms a step (the three
walls and their median), tokens a second, the peak memory of the timed
steps (the largest over the ranks), the step's collectives counted by
``CollectiveCount``, its kernel launches and registry dispatches, and the
loss of every step (with ``--profile``, one more step under
``torch.profiler``: the card's busy share and its time by kind of
kernel); then the line
``{"dp_step_time": {...}}`` with the same numbers (also written to
``--out``). A run that does not fit ends with the out-of-memory error,
the bytes it asked for, and rank 0's card at that moment (allocated,
reserved, free, and the context outside the allocator). It imports no JAX.

  python tools/dp_step_time.py --compare a.json b.json ...

prints, for the runs those ``--out`` files hold, each run's losses and
their largest difference from the first run's, relative, and exits 1 when
one passes ``SCALAR_RTOL`` (the port's tests' tolerance on a loss).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.core.distributed import CollectiveCount  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.dist import Mesh, make_rules  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch.steps import (init_train_state,  # noqa: E402
                                      layout, make_train_step)

TIMED = 3
#: tests/test_torch_ca_sync.py's tolerance on a loss
SCALAR_RTOL = 5e-3


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _cards():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()


def _memory_now(dev) -> dict:
    """This rank's card at this moment (in the handler of an out-of-memory
    error: the step's tensors still live, its process groups' communicators
    made): what PyTorch's allocator has allocated and reserved, its
    reserved blocks split but unused, the card's free bytes, and the
    context, the bytes the process holds outside the allocator (its CUDA
    context, cuBLAS, the NCCL communicators): total less free less
    reserved."""
    if dev.type != "cuda":
        return {}
    free, total = torch.cuda.mem_get_info(dev)
    stats = torch.cuda.memory_stats(dev)
    reserved = torch.cuda.memory_reserved(dev)
    return dict(allocated=torch.cuda.memory_allocated(dev),
                reserved=reserved, free=free, total=total,
                context=total - free - reserved,
                inactive_split=stats.get("inactive_split_bytes.all.current"),
                alloc_retries=stats.get("num_alloc_retries"))


def stream_batch(args, cfg, dev):
    """One more batch of the run's stream (its step 5)."""
    B, S = (8 * args.ca_k, 1024) if args.preset == "full" else (8, 64)
    stream = TokenStream(B, S, cfg.vocab, seed=0, start_step=1 + TIMED,
                         device=dev)
    try:
        return next(stream)
    finally:
        stream.close()


def _self_device_us(ev) -> float:
    return float(getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0)))


def _profiled_step(step, state, batch) -> dict:
    """One step under ``torch.profiler`` on this rank: its wall, the
    card's busy time (the kernels' self time) and share, the time by kind
    of kernel (NCCL collectives, the flash kernels, GEMMs, the rest) and
    the ten kernels that take most."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # the card's kernels only: the host's DTensor dispatch would be
    # millions of CPU events
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds = dict(nccl=0.0, flash=0.0, gemm=0.0, other=0.0)
    rows = []
    for ev in prof.key_averages():
        us = _self_device_us(ev)
        if us <= 0:
            continue
        name = ev.key.lower()
        kind = ("nccl" if "nccl" in name else "flash" if "flash" in name
                else "gemm" if any(k in name for k in
                                   ("gemm", "nvjet", "xmma", "cutlass",
                                    "sm90"))
                else "other")
        kinds[kind] += us / 1e3
        rows.append((us / 1e3, ev.key[:80], ev.count))
    busy = sum(kinds.values())
    rows.sort(reverse=True)
    return dict(wall_ms=wall * 1e3, busy_ms=busy,
                busy_share=busy / (wall * 1e3), by_kind_ms=kinds,
                top=[dict(ms=ms, kernel=k, calls=n) for ms, k, n in rows[:10]])


def run(args, dev) -> dict:
    cfg = get_arch(args.arch)
    B, S = (8 * args.ca_k, 1024) if args.preset == "full" else (8, 64)
    if args.preset == "tiny":
        cfg = smoke_config(cfg)
    rules = None
    if args.mesh != "single":
        D, M = (int(v) for v in args.mesh.split(","))
        rules = make_rules(Mesh(("data", "model"), (D, M)), dist.group.WORLD)
    count = CollectiveCount()
    step = make_train_step(cfg, rules, ca_k=args.ca_k, remat=True,
                           counter=count, warmup=10, total_steps=100)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev, rules=rules)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    stream = TokenStream(B, S, cfg.vocab, seed=0, device=dev)
    losses, walls, tp_comms = [], [], {}
    try:
        batch = next(stream)
        if rules is not None and rules.tp_size > 1:
            from torch.distributed.tensor.debug import CommDebugMode
            with CommDebugMode() as comm:
                state, m = step(state, batch)
            tp_comms = {str(k): v for k, v in comm.get_comm_counts().items()}
        else:
            state, m = step(state, batch)
        losses.append(float(m["loss"]))
        before = dict(vars(count))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        registry.reset_dispatch_counts()
        kernels.reset_launch_counts()
        for _ in range(TIMED):
            batch = next(stream)
            _sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            _sync(dev)
            walls.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
    finally:
        stream.close()
    dispatches = {f"{op}/{be}": n / TIMED for (op, be), n in
                  registry.dispatch_counts().items()}
    launches = {op: n / TIMED for op, n in kernels.launch_counts().items()
                if n}
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    per_step = {k: (v - before[k]) / TIMED for k, v in vars(count).items()}
    profile = None
    if args.profile and dev.type == "cuda":
        profile = _profiled_step(step, state, stream_batch(args, cfg, dev))
    if rules is not None:
        t = torch.tensor([float(peak)], device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        peak = int(t.item())
    ms = sorted(w * 1e3 for w in walls)[TIMED // 2]
    return dict(arch=cfg.name, preset=args.preset, mesh=args.mesh,
                batch=[B, S], ca_k=args.ca_k,
                shard_bytes=(layout(cfg, rules).shard_bytes()
                             if rules is not None else None),
                walls_ms=[w * 1e3 for w in walls], median_ms=ms,
                tokens_s=B * S / (ms * 1e-3), peak_gib=peak / 2 ** 30,
                collectives_a_step=per_step, tp_collectives_warmup=tp_comms,
                dispatches_a_step=dispatches, launches_a_step=launches,
                profile=profile,
                losses=losses)


def compare(paths) -> int:
    runs = [json.loads(Path(p).read_text())["dp_step_time"] for p in paths]
    first = runs[0]["losses"]
    worst = 0.0
    for path, run in zip(paths, runs):
        rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], first))
        worst = max(worst, rel)
        print(f"{run['arch']} mesh {run['mesh']} ({path}): losses "
              f"{run['losses']}, largest difference from the first run "
              f"{rel:.3e} relative")
    print(f"largest: {worst:.3e} (limit {SCALAR_RTOL})")
    return 0 if worst <= SCALAR_RTOL else 1


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "--compare":
        return compare(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--preset", choices=["full", "tiny"], default="full")
    ap.add_argument("--ca-k", type=int, default=4)
    ap.add_argument("--mesh", default="4,1",
                    help="DATA,MODEL over the default group, or single")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="profile one more step on each card (rank 0's "
                    "kernels printed)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.mesh != "single":
        dev = mesh.init(dev.type)
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        try:
            out = run(args, dev)
        except torch.OutOfMemoryError as e:
            out = dict(arch=args.arch, mesh=args.mesh, out_of_memory=str(e),
                       at_oom=_memory_now(dev))
        if dev.type == "cuda":
            out["cards"] = _cards()
        if rank == 0:
            if "out_of_memory" in out:
                print(f"{args.arch} mesh {args.mesh}: out of memory: "
                      f"{out['out_of_memory']}; rank 0's card then, bytes: "
                      f"{out['at_oom']}")
            else:
                print(f"cards: {out.get('cards')}")
                print(f"{out['arch']} mesh {out['mesh']}: median "
                      f"{out['median_ms']:.1f} ms a step "
                      f"{[round(w, 1) for w in out['walls_ms']]}, "
                      f"{out['tokens_s']:.0f} tokens/s, peak "
                      f"{out['peak_gib']:.2f} GiB a card, shard "
                      f"{out['shard_bytes']} bytes a rank, collectives a "
                      f"step {out['collectives_a_step']}, model-axis "
                      f"collectives of the warm-up step "
                      f"{out['tp_collectives_warmup']}, kernel launches "
                      f"a step {out['launches_a_step']}, dispatches a step "
                      f"{out['dispatches_a_step']}, losses "
                      f"{out['losses']}")
            if out.get("profile"):
                pr = out["profile"]
                print(f"profiled step on rank 0: {pr['wall_ms']:.1f} ms, "
                      f"the card busy {pr['busy_ms']:.1f} ms "
                      f"({100 * pr['busy_share']:.1f}%), by kind "
                      f"{ {k: round(v, 1) for k, v in pr['by_kind_ms'].items()} }")
                for row in pr["top"]:
                    print(f"  {row['ms']:9.2f} ms {row['calls']:6d} calls "
                          f"{row['kernel']}")
            line = json.dumps({"dp_step_time": out})
            print(line)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                Path(args.out).write_text(line + "\n")
    finally:
        if args.mesh != "single":
            mesh.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

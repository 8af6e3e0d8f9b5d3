"""Time the data-parallel CA train step against the classical schedule on
the cards of one host (or CPU ranks), one process a rank.

  torchrun --nproc-per-node 4 tools/dp_step_time.py
  torchrun --nproc-per-node 2 tools/dp_step_time.py --device cpu --preset tiny

Every rank takes its slice of the same global batch (``TokenStream(32,
1024)``, seed 0, at the full preset: phase 11's configuration) and runs
``make_train_step(cfg, rules)`` over the default group, once with the CA
schedule (one all-reduce of the flat gradient buffer a step) and once with
``sync_every_microbatch`` (ca_k all-reduces a step), on one training state:
a warm-up step of each, then timed steps in the order CA, classical,
classical, CA, CA, classical, each between two synchronizes. Rank 0 prints
the card's name and power limit, the world size, each schedule's ms a step
(all six walls and the medians), tokens a second, all-reduces and words a
step counted by ``CollectiveCount``, the all-reduce of one step's words
alone (CUDA events, its bus rate), and the peak memory; then the line
``{"dp_step_time": {...}}`` with the same numbers. It imports no JAX.
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
from repro_torch.dist import data_rules  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch.steps import (init_train_state,  # noqa: E402
                                      make_train_step)
from repro_torch.tree import leaves  # noqa: E402

ORDER = (True, False, False, True, True, False)     # True: the CA schedule


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--preset", choices=["full", "tiny"], default="full")
    ap.add_argument("--ca-k", type=int, default=4)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    dev = mesh.init(resolve_device(args.device).type)
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        cfg = get_arch(args.arch)
        B, S = (8 * args.ca_k, 1024) if args.preset == "full" else (8, 64)
        if args.preset == "tiny":
            cfg = smoke_config(cfg)
        rules = data_rules(dist.group.WORLD)
        counts = {True: CollectiveCount(), False: CollectiveCount()}
        steps = {ca: make_train_step(cfg, rules, ca_k=args.ca_k,
                                     remat=True, counter=counts[ca],
                                     sync_every_microbatch=not ca)
                 for ca in (True, False)}
        state = init_train_state(cfg, torch.Generator(
            device=dev).manual_seed(0), device=dev)
        stream = TokenStream(B, S, cfg.vocab, seed=0, device=dev)
        try:
            for ca in (True, False):                  # warm-up
                state, _ = steps[ca](state, next(stream))
            _sync(dev)
            for c in counts.values():
                c.all_reduces = c.words = 0
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            walls = {True: [], False: []}
            for ca in ORDER:
                batch = next(stream)
                _sync(dev)
                t0 = time.perf_counter()
                state, m = steps[ca](state, batch)
                _sync(dev)
                walls[ca].append(time.perf_counter() - t0)
                if not torch.isfinite(m["loss"]):
                    raise RuntimeError(f"loss not finite: {m}")
        finally:
            stream.close()
        n = sum(t.numel() for t in leaves(state.params)) + 1
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" \
            else 0
        del state
        # the collective alone: one step's words
        buf = torch.zeros(n, device=dev)
        for _ in range(2):
            dist.all_reduce(buf)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(5):
            dist.all_reduce(buf)
        _sync(dev)
        ar_ms = (time.perf_counter() - t0) / 5 * 1e3
        # a ring all-reduce moves 2 (P-1)/P of the buffer through each link
        bus = 2 * (world - 1) / world * 4 * n / (ar_ms * 1e-3) / 1e9
        out = dict(world=world, arch=cfg.name, preset=args.preset,
                   batch=[B, S], ca_k=args.ca_k, words_a_step=n,
                   peak_gib=peak / 2 ** 30, all_reduce_ms=ar_ms,
                   all_reduce_bus_gb_s=bus)
        for ca, name in ((True, "ca"), (False, "classical")):
            ms = sorted(w * 1e3 for w in walls[ca])
            runs = len(walls[ca])
            out[name] = dict(walls_ms=[w * 1e3 for w in walls[ca]],
                             median_ms=ms[len(ms) // 2],
                             tokens_s=B * S / (ms[len(ms) // 2] * 1e-3),
                             all_reduces_a_step=counts[ca].all_reduces / runs,
                             words_a_step=counts[ca].words / runs)
        if rank == 0:
            if dev.type == "cuda":
                card = subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], capture_output=True,
                    text=True).stdout.strip().splitlines()
                print(f"cards: {card}")
            for name in ("ca", "classical"):
                r = out[name]
                print(f"world {world} {name}: median {r['median_ms']:.1f} "
                      f"ms a step {[round(w, 1) for w in r['walls_ms']]}, "
                      f"{r['tokens_s']:.0f} tokens/s, "
                      f"{r['all_reduces_a_step']:g} all-reduces "
                      f"({r['words_a_step']:.0f} words) a step")
            print(f"world {world}: all_reduce of {n} words "
                  f"{ar_ms:.2f} ms ({bus:.1f} GB/s bus), peak "
                  f"{out['peak_gib']:.2f} GiB")
            print(json.dumps({"dp_step_time": out}))
    finally:
        mesh.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

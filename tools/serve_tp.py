"""Serve a model on the cards of one host, tensor-parallel over the model
axis (sharded serving: ``Engine(..., rules=make_rules(Mesh(("data",
"model"), (1, m)), group))``), one process a card, or on one card.

  python tools/serve_tp.py --mesh single --max-len 1024 --out single.json
  torchrun --nproc-per-node 4 tools/serve_tp.py --mesh 1,4 \\
      --compare single.json --out tp4.json
  torchrun --nproc-per-node 2 tools/serve_tp.py --mesh 1,2 \\
      --compare single.json --out tp2.json
  torchrun --nproc-per-node 2 tools/serve_tp.py --device cpu \\
      --preset tiny --mesh 1,2 --max-len 128 --requests 6 \\
      --prompt-max 24 --new-tokens 8

Every rank builds the same weights (a ``torch.Generator`` seeded 0, bf16,
at the published widths of ``--arch``; ``--preset tiny`` its smoke
config), keeps its tensor-parallel shards (``launch.steps.serve_params``)
and drops the whole tree before the pool is allocated. The engine's paged
pool holds ``--slots`` slots of ``--max-len`` positions in pages of
``--page-size`` (llama3-8b at 32 x 32,768: 128 GiB in all, a quarter a
card at (1, 4)). ``--requests`` requests with prompts of
``--prompt-min``..``--prompt-max`` tokens (numpy, seed 0), ``--new-tokens``
each, the odd ones sampled (T 0.8, top-p 0.9, top-k 50, seed = the
index), drain through the k-step engine. Rank 0 prints the cards' names
and power limits, the mesh, the pool's bytes a card and the peak memory
(the largest over the ranks), the first block (set-up) apart from the
steady state's tok/s, ms a step and ms a sync, ``paged_decode`` launches a
step, the collectives of a decode step (a separate one-slot engine's
step at k = 1, counted by DTensor's ``CommDebugMode``; the merge's gathers
also by the engine), one block profiled (``torch.profiler``: the card's
busy share and its time by kind of kernel), and, against ``--compare``
(another run's ``--out``), how many streams equal that run's and where
the others part; with ``--agree N``, the sharded model's logits against
one card's (the whole weights, on each rank before they are dropped) on
the same N tokens fed one a step (the requests' prompts, one row): the
largest difference in bf16 ulps of the logits' top, and at each step
where the two picks differ, the gap between one card's top two logits in
the same ulps; then the line ``{"serve_tp": {...}}`` (also written to
``--out``). Every rank must return the same streams. It imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import kernels, resolve_device  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.dist import Mesh, make_rules  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch.steps import serve_params  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import Engine, Request, SamplingParams  # noqa: E402

#: the tools' profile of one block: the kernels' kinds
KINDS = ("nccl", "paged_decode", "gemm", "other")


def _cards():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def requests(args, cfg):
    rng = np.random.RandomState(0)
    out = []
    for i in range(args.requests):
        n = int(rng.randint(args.prompt_min, args.prompt_max + 1))
        prompt = rng.randint(0, cfg.vocab, size=n).tolist()
        sp = SamplingParams(temperature=0.8, top_p=0.9, top_k=50, seed=i) \
            if i % 2 else None
        out.append(Request(id=f"r{i:03d}", prompt=prompt,
                           max_new_tokens=args.new_tokens, sampling=sp))
    return out


def _profiled_step(engine, dev):
    """One round of the engine (one k-step block and its fetch) under
    ``torch.profiler``: its wall, the card's busy time and share, and the
    time by kind of kernel; and the round's responses."""
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = engine.step()
        _sync(dev)
        wall = time.perf_counter() - t0
    kinds = dict.fromkeys(KINDS, 0.0)
    for ev in prof.key_averages():
        us = float(getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0)))
        if us <= 0:
            continue
        name = ev.key.lower()
        kind = ("nccl" if "nccl" in name else "paged_decode"
                if "paged_decode" in name else "gemm"
                if any(k in name for k in ("gemm", "nvjet", "xmma",
                                           "cutlass", "sm90"))
                else "other")
        kinds[kind] += us / 1e3
    busy = sum(kinds.values())
    return dict(wall_ms=wall * 1e3, busy_ms=busy,
                busy_share=busy / (wall * 1e3), by_kind_ms=kinds), out


def _step_collectives(params, cfg, rules, args, dev) -> dict:
    """The collectives of one decode step (k = 1) of a one-slot engine on
    the same mesh, by DTensor's ``CommDebugMode``, and the engine's own
    count of the merge's gathers."""
    from torch.distributed.tensor.debug import CommDebugMode
    eng = Engine(params, cfg, num_slots=1, max_len=4 * args.page_size,
                 k=1, max_prompt=2, page_size=args.page_size, device=dev,
                 rules=rules)
    eng.submit(Request(id="c", prompt=[1, 2], max_new_tokens=4))
    eng.step()
    before = eng.collectives.all_gathers
    with CommDebugMode() as comm:
        eng.step()
    _sync(dev)
    return dict(comm={str(k): v for k, v in comm.get_comm_counts().items()},
                merge_gathers=eng.collectives.all_gathers - before)


def _agreement(full, params, cfg, rules, tokens, dev) -> dict:
    """The sharded model (``params`` on ``rules``) against one card's
    (``full``) on ``tokens`` fed one a step into one-row slot caches: per
    step the largest |logit difference| and, where the argmax differs,
    one card's top-two gap, both in bf16 ulps at one card's top logit."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.serve import CachePool
    n = len(tokens)
    pools = (CachePool(cfg, 1, n + 1, device=dev, rules=rules),
             CachePool(cfg, 1, n + 1, device=dev))
    caches = [p.make_cache() for p in pools]
    steps = (make_serve_step(cfg, rules, kv_rows=pools[0].rows),
             make_serve_step(cfg))
    worst, flips = 0.0, []
    for i, tok in enumerate(tokens):
        t = torch.tensor([[tok]], dtype=torch.int32, device=dev)
        pos = torch.tensor([i], dtype=torch.int32, device=dev)
        lg = []
        for j, (step, w) in enumerate(zip(steps, (params, full))):
            _, logits, caches[j] = step(w, caches[j], t, pos)
            lg.append(logits[0, -1].float())
        top = lg[1].topk(2).values
        ulp = 2.0 ** (torch.floor(torch.log2(top[0].abs())) - 7)
        worst = max(worst, float(((lg[0] - lg[1]).abs().max()) / ulp))
        if int(lg[0].argmax()) != int(lg[1].argmax()):
            flips.append(float((top[0] - top[1]) / ulp))
    return dict(steps=n, max_delta_ulps=worst, flips=len(flips),
                flip_gaps_ulps=flips)


def _parted(got: dict, want: dict) -> dict:
    """Streams equal to ``want``'s, and where each other one parts."""
    parts = {}
    for rid, toks in got.items():
        w = want.get(rid)
        if w is None or toks == w:
            continue
        parts[rid] = next((i for i, (a, b) in enumerate(zip(toks, w))
                           if a != b), min(len(toks), len(w)))
    return dict(equal=sum(got[r] == want.get(r) for r in got),
                streams=len(got), parted_at=parts)


def run(args, dev) -> dict:
    cfg = get_arch(args.arch)
    if args.preset == "tiny":
        cfg = smoke_config(cfg)
    rules = None
    if args.mesh != "single":
        D, M = (int(v) for v in args.mesh.split(","))
        rules = make_rules(Mesh(("data", "model"), (D, M)), dist.group.WORLD)
    full = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                       dtype=torch.bfloat16, device=dev)
    params = serve_params(cfg, full, rules)
    agree = None
    if rules is not None and args.agree:
        toks = [t for r in requests(args, cfg) for t in r.prompt]
        agree = _agreement(full, params, cfg, rules, toks[:args.agree], dev)
    del full
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    comms = _step_collectives(params, cfg, rules, args, dev) \
        if rules is not None else {}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    eng = Engine(params, cfg, num_slots=args.slots, max_len=args.max_len,
                 k=args.k, max_prompt=args.prompt_max,
                 page_size=args.page_size, device=dev, rules=rules)
    pool_bytes = eng.pool.page_bytes() * eng.pool.num_pages
    reqs = requests(args, cfg)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    out = eng.step()                        # the first block: set-up
    _sync(dev)
    first_s = time.perf_counter() - t0
    tok0, syncs0 = eng.stats.tokens_out, eng.stats.syncs
    kernels.reset_launch_counts()
    profile = None
    dt, skip_tok, skip_syncs = 0.0, 0, 0
    while not eng._drained():
        if profile is None and args.profile and dev.type == "cuda" and \
                eng.stats.syncs == syncs0 + 4:
            # one block under the profiler, left out of the steady state
            tok = eng.stats.tokens_out
            profile, got = _profiled_step(eng, dev)
            out += got
            skip_tok += eng.stats.tokens_out - tok
            skip_syncs += 1
            continue
        t0 = time.perf_counter()
        out += eng.step()
        dt += time.perf_counter() - t0
    _sync(dev)
    s = eng.stats
    launches = kernels.launch_counts().get("paged_decode", 0)
    syncs = s.syncs - syncs0 - skip_syncs
    steps = syncs * args.k
    launch_steps = (s.syncs - syncs0) * args.k
    streams = {r.id: list(r.tokens) for r in out}
    same = True
    if rules is not None:
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, streams)
        same = all(e == streams for e in every)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if rules is not None:
        t = torch.tensor([peak], dtype=torch.int64,
                         device=dev if dev.type == "cuda" else "cpu")
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        peak = int(t.item())
    rec = dict(arch=cfg.name, mesh=args.mesh, cards=_cards()
               if dev.type == "cuda" else [], slots=args.slots,
               max_len=args.max_len, page_size=args.page_size, k=args.k,
               requests=len(reqs), retired=s.retired,
               pool_bytes_a_card=pool_bytes,
               pool_gib_a_card=pool_bytes / 2 ** 30,
               peak_bytes_a_card=peak, peak_gib_a_card=peak / 2 ** 30,
               first_block_s=first_s, steady_s=dt,
               steady_tokens=s.tokens_out - tok0 - skip_tok,
               tok_s=(s.tokens_out - tok0 - skip_tok) / dt if dt else 0.0,
               ms_step=dt / max(steps, 1) * 1e3,
               ms_sync=dt / max(syncs, 1) * 1e3,
               paged_decode_a_step=launches / max(launch_steps, 1),
               merge_gathers_a_step=None, step_collectives=comms,
               profile=profile, ranks_agree=same, one_card_logits=agree,
               streams=streams)
    if rules is not None:
        rec["merge_gathers_a_step"] = comms["merge_gathers"]
    if args.compare:
        want = json.loads(Path(args.compare).read_text())["streams"]
        rec["against"] = dict(run=args.compare, **_parted(streams, want))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--preset", choices=["full", "tiny"], default="full")
    ap.add_argument("--mesh", default="1,4",
                    help="D,M over the default group, or single (one "
                    "process, rules None)")
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=32768)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-min", type=int, default=32)
    ap.add_argument("--prompt-max", type=int, default=512)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--agree", type=int, default=0,
                    help="hold the sharded logits to one card's over this "
                    "many tokens fed one a step (0: no)")
    ap.add_argument("--profile", action="store_true",
                    help="profile one block on each card")
    ap.add_argument("--compare", default=None,
                    help="another run's --out: count the streams that "
                    "equal its")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    joined = False
    if args.mesh != "single":
        dev = mesh.init(dev.type)
        joined = True
    rank = dist.get_rank() if joined else 0
    try:
        rec = run(args, dev)
    finally:
        if joined:
            mesh.shutdown()
    if rank == 0:
        for card in rec["cards"]:
            print(f"card: {card}")
        print(f"{rec['arch']} mesh {rec['mesh']}: pool "
              f"{rec['pool_gib_a_card']:.2f} GiB a card "
              f"({args.slots} slots x {args.max_len} positions, pages of "
              f"{args.page_size}), peak {rec['peak_gib_a_card']:.2f} GiB a "
              f"card; {rec['retired']}/{rec['requests']} retired; first "
              f"block {rec['first_block_s']:.2f} s; steady "
              f"{rec['tok_s']:.1f} tok/s, {rec['ms_step']:.2f} ms a step, "
              f"{rec['ms_sync']:.2f} ms a sync at k={args.k}; "
              f"paged_decode {rec['paged_decode_a_step']:.1f} a step; "
              f"ranks agree: {rec['ranks_agree']}")
        if rec["step_collectives"]:
            print(f"a decode step's collectives: "
                  f"{rec['step_collectives']}")
        if rec["profile"]:
            pr = rec["profile"]
            print(f"profiled block: {pr['wall_ms']:.1f} ms, the card busy "
                  f"{pr['busy_ms']:.1f} ms ({100 * pr['busy_share']:.1f}%),"
                  f" by kind {pr['by_kind_ms']}")
        if rec["one_card_logits"]:
            print(f"against one card's logits: {rec['one_card_logits']}")
        if "against" in rec:
            a = rec["against"]
            print(f"streams equal to {a['run']}'s: {a['equal']}/"
                  f"{a['streams']}; parted at {a['parted_at']}")
        print(json.dumps({"serve_tp": {k: v for k, v in rec.items()
                                       if k != "streams"}}))
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(rec))
    return 0 if rec["ranks_agree"] and rec["retired"] == rec["requests"] \
        else 1


if __name__ == "__main__":
    sys.exit(main())

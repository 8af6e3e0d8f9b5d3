"""Measure the paper's cost-model constants (T = gamma F + alpha L + beta W,
``repro_torch.core.cost_model``) on the cards of one host, and run the
distributed CA solvers (paper Algorithm V, ``core/distributed.py``) across
them beside the model's prediction.

  torchrun --nproc-per-node 4 tools/machine_params.py --out X.json
  torchrun --nproc-per-node 4 tools/machine_params.py --device cpu \\
      --scale 0.05 --max-log2-words 14          # a rehearsal on CPU ranks

One process a card (``nccl``; ``gloo`` on CPU ranks). Rank 0 prints:

1. the cards: ``nvidia-smi`` name and power limit, ``total_memory``, the
   memory a rank's CUDA context, cuBLAS and NCCL take outside PyTorch's
   allocator (``mem_get_info`` less what the allocator reserved, the
   largest over the ranks: with the default group's communicator alone,
   and with every group of this run; a train step's own is what
   ``tools/dp_step_time.py`` reads at an out-of-memory error),
   ``nvidia-smi nvlink -s`` and ``nvidia-smi topo -m``;
2. alpha and beta: ``dist.all_reduce`` of one contiguous float32 buffer
   (the dtype ``core/distributed.py`` reduces) from 1 to 2^26 words, in
   groups of 2 and of all the ranks: the time of one call is the median
   over repeats of CUDA events around a burst of back-to-back calls, each
   repeat after a barrier. Each world's T(w) = a + b w is fitted by least
   squares of the relative residuals (a plain fit would leave a to the
   largest buffers), and the model's alpha and beta jointly over the
   worlds as T_P(w) = log2(P) (alpha + beta w), the hops
   ``CostModel.messages`` and ``CostModel.words`` count;
3. gamma: seconds per flop as the main path runs it, ``gram_gather`` at
   the covtype CA block (k = 32 draws of m = 58,101 rows, d + 1 = 55), over
   the flops ``CostModel.flops`` counts for it (k d^2 m), beside the
   float32 peak's 1 / ``H100.peak_flops_f32``;
4. the solves at worlds 1, 2 and all: CA-SFISTA and SFISTA on covtype,
   CA-SPNM and SPNM on susy, at full size (``data.make_dataset_like``),
   T = 256, k = 32, b = 0.1, Q = 5, each rank its column block and its
   own draws: the warm wall (the median of three after one untimed solve),
   the counted all-reduces and words, ``CostModel.time`` and ``speedup``
   with this run's constants, the CA iterate against the classical one
   (relative) and the relative solution error;

then the line ``{"machine_params": {...}}`` with the same numbers (also
written to ``--out``). It imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core import (SolverConfig, relative_solution_error,  # noqa
                              solve_reference)
from repro_torch.core.cost_model import CostModel, MachineParams  # noqa: E402
from repro_torch.core.distributed import (CollectiveCount,  # noqa: E402
                                          make_distributed_solver,
                                          shard_problem)
from repro_torch.core.sampling import sample_index_batch  # noqa: E402
from repro_torch.data import make_dataset_like  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.roofline import H100  # noqa: E402

#: phase 5's solves: T, k, b, Q
T, K, B, Q = 256, 32, 0.1, 5
#: (dataset, scale at full size, CA algorithm, classical, newton)
SOLVES = (("covtype", 10, "ca_sfista", "sfista", False),
          ("susy", 50, "ca_spnm", "spnm", True))
REPEATS = 7


def fit_alpha_beta(words, seconds, hops=None):
    """(alpha, beta) of T = h (alpha + beta w) over the points (w, T) with
    h the hops of each point (default 1), by least squares of the relative
    residuals (T_fit - T) / T: a 2 x 2 normal system."""
    hops = [1.0] * len(words) if hops is None else hops
    s_aa = s_ab = s_bb = s_a = s_b = 0.0
    for w, t, h in zip(words, seconds, hops):
        a, b = h / t, h * w / t          # d(residual)/d(alpha), /d(beta)
        s_aa += a * a
        s_ab += a * b
        s_bb += b * b
        s_a += a
        s_b += b
    det = s_aa * s_bb - s_ab * s_ab
    return (s_a * s_bb - s_b * s_ab) / det, (s_aa * s_b - s_ab * s_a) / det


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _burst_s(fn, dev, n):
    """Seconds a call of ``fn`` over a burst of ``n`` back-to-back calls:
    CUDA events on the card, the host clock on the CPU."""
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) * 1e-3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def sweep(group, dev, max_log2: int):
    """[(words, median seconds a call)] of all_reduce over ``group`` (None
    on ranks outside it, which only meet the barriers)."""
    inside = group is not None
    out = []
    for e in range(max_log2 + 1):
        w = 1 << e
        buf = torch.ones(w, dtype=torch.float32, device=dev) if inside \
            else None
        n = 20 if w <= 1 << 18 else 5

        def call():
            dist.all_reduce(buf, group=group)
        times = []
        for _ in range(REPEATS):
            dist.barrier()
            if inside:
                call()            # warm: the buffer's first use
                _sync(dev)
                times.append(_burst_s(call, dev, n))
        if inside:
            out.append((w, statistics.median(times)))
        del buf
    return out


def measure_gamma(dev):
    """gram_gather at the covtype CA block: (seconds a call, the flops
    CostModel counts for it, gamma)."""
    problem, _ = make_dataset_like("covtype", scale=10, device=dev)
    n, d = problem.n, problem.d
    m = max(int(B * n), 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = sample_index_batch(gen, K, n, m)
    rows = problem.Xy_rows

    def call():
        registry.dispatch("gram_gather", rows, idx, d + 1, 1.0 / m)
    call()
    _sync(dev)
    s = statistics.median(_burst_s(call, dev, 20) for _ in range(REPEATS))
    flops = float(K * d * d * m)
    return dict(shape=[K, d + 1, m], seconds=s, flops=flops, gamma=s / flops,
                gamma_peak_f32=1.0 / H100.peak_flops_f32)


def run_solves(mine, dev, params: MachineParams, scale=None):
    """Phase 5's four solves over the first P ranks for each P of ``mine``
    (P -> its group, None on ranks outside it). Returns rank 0's
    records."""
    out = []
    rank = dist.get_rank()
    for dataset, full, ca_alg, cl_alg, newton in SOLVES:
        problem, _ = make_dataset_like(dataset, scale=scale or full,
                                       device=dev)
        cfg = SolverConfig(T=T, k=K, b=B, Q=Q)
        t = problem.default_step(cfg)
        w_opt = solve_reference(problem)
        cm = CostModel(d=problem.d, n=problem.n, b=B, T=T, k=K, Q=Q)
        for world, group in sorted(mine.items()):
            ws, recs = {}, {}
            if group is not None:
                X, y = shard_problem(problem.X, problem.y, rank, world)
            for alg in (ca_alg, cl_alg):
                walls, count = [], CollectiveCount()
                for i in range(4):           # one untimed, three timed
                    dist.barrier()
                    if group is None:
                        continue
                    solve = make_distributed_solver(
                        alg, cfg, problem.lam, group=group,
                        counter=count if i == 0 else None)
                    w0 = torch.zeros(problem.d, device=dev)
                    _sync(dev)
                    t0 = time.perf_counter()
                    ws[alg] = solve(X, y, w0, t, gen=0)
                    _sync(dev)
                    if i:
                        walls.append(time.perf_counter() - t0)
                if group is not None:
                    recs[alg] = dict(
                        algorithm=alg, dataset=dataset, world=world,
                        walls_s=walls, wall_s=statistics.median(walls),
                        all_reduces=count.all_reduces, words=count.words,
                        rel_err=float(relative_solution_error(ws[alg],
                                                              w_opt)),
                        predicted_s=cm.time(world, params,
                                            ca=alg == ca_alg, newton=newton))
            if group is None or rank != 0:
                continue
            ca_w, cl_w = ws[ca_alg], ws[cl_alg]
            diff = float((ca_w - cl_w).norm() / cl_w.norm().clamp_min(1e-30))
            for alg in (ca_alg, cl_alg):
                recs[alg].update(
                    ca_vs_classical=diff,
                    speedup_measured=(recs[cl_alg]["wall_s"]
                                      / recs[ca_alg]["wall_s"]),
                    speedup_predicted=cm.speedup(world, params,
                                                 newton=newton))
                out.append(recs[alg])
    return out


def _context(dev) -> int:
    """The bytes of the card this rank's process holds outside PyTorch's
    caching allocator (its CUDA context, cuBLAS, NCCL's communicators):
    total less free less what the allocator reserved; the largest over
    the ranks. 0 on the CPU."""
    if dev.type != "cuda":
        return 0
    _sync(dev)
    free, total = torch.cuda.mem_get_info(dev)
    t = torch.tensor([float(total - free - torch.cuda.memory_reserved(dev))],
                     device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def _cards(dev):
    if dev.type != "cuda":
        return {}

    def smi(*a):
        return subprocess.run(["nvidia-smi", *a], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    return dict(name_power=smi("--query-gpu=name,power.limit",
                               "--format=csv,noheader").splitlines(),
                total_memory=torch.cuda.get_device_properties(
                    dev).total_memory,
                nvlink=smi("nvlink", "-s"), topo=smi("topo", "-m"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--scale", type=float, default=None,
                    help="dataset scale for every solve (default: each "
                    "dataset at full size)")
    ap.add_argument("--max-log2-words", type=int, default=26)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    dev = mesh.init(resolve_device(args.device).type)
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        cards = _cards(dev)
        # the context with one communicator (the default group's), then
        # with the sweep's and solves' groups too
        dist.all_reduce(torch.ones(1, device=dev))
        torch.ones(64, 64, device=dev) @ torch.ones(64, 64, device=dev)
        context = _context(dev)
        groups = {P: dist.new_group(list(range(P)))
                  for P in sorted({1, 2, world}) if P <= world}
        mine = {P: (g if rank < P else None) for P, g in groups.items()}
        for P, g in mine.items():
            if g is not None:
                dist.all_reduce(torch.ones(1, device=dev), group=g)
        context_all = _context(dev)

        fits = {}
        points = []
        for P in sorted(p for p in mine if p > 1):
            pts = sweep(mine[P], dev, args.max_log2_words)
            if rank == 0:
                a, b = fit_alpha_beta(*zip(*pts))
                fits[P] = dict(alpha=a, beta=b, points=pts)
                points += [(w, s, math.log2(P)) for w, s in pts]
        gamma = measure_gamma(dev)
        model = None
        if rank == 0:
            ws, ss, hs = zip(*points)
            alpha, beta = fit_alpha_beta(ws, ss, hs)
            model = MachineParams("h100 (this run)", gamma=gamma["gamma"],
                                  alpha=alpha, beta=beta)
        box = [model]
        dist.broadcast_object_list(box, src=0)
        model = box[0]
        solves = run_solves(mine, dev, model, args.scale)

        if rank == 0:
            print(f"cards: {cards.get('name_power')}, total_memory "
                  f"{cards.get('total_memory')} bytes, context {context} "
                  f"bytes a rank with the default group's communicator, "
                  f"{context_all} with every group's (the largest rank)")
            for key in ("nvlink", "topo"):
                if cards.get(key):
                    print(f"nvidia-smi {key}:\n{cards[key]}")
            for P, f in fits.items():
                print(f"all_reduce at world {P}: T(w) = {f['alpha']:.4e} s "
                      f"+ {f['beta']:.4e} s/word (float32)")
                for w, s in f["points"]:
                    print(f"  {w:10d} words {s * 1e6:12.2f} us")
            print(f"model fit (T_P = log2 P (alpha + beta w), worlds "
                  f"{sorted(fits)}): alpha={model.alpha:.4e} s, "
                  f"beta={model.beta:.4e} s/word")
            print(f"gamma: gram_gather {gamma['shape']} {gamma['seconds'] * 1e3:.4f} "
                  f"ms over {gamma['flops']:.4e} flop = {gamma['gamma']:.4e} "
                  f"s/flop (the float32 peak's {gamma['gamma_peak_f32']:.4e})")
            for r in solves:
                print(f"world {r['world']} {r['dataset']:8s} "
                      f"{r['algorithm']:10s} wall {r['wall_s'] * 1e3:9.3f} ms "
                      f"{[round(w * 1e3, 3) for w in r['walls_s']]} "
                      f"predicted {r['predicted_s'] * 1e3:9.3f} ms; "
                      f"all-reduces {r['all_reduces']}, words {r['words']}; "
                      f"CA vs classical {r['ca_vs_classical']:.3e}; rel_err "
                      f"{r['rel_err']:.4f}; speedup measured "
                      f"{r['speedup_measured']:.3f}x, predicted "
                      f"{r['speedup_predicted']:.3f}x")
            line = json.dumps({"machine_params": dict(
                cards=cards, context_bytes=context,
                context_all_groups_bytes=context_all, fits=fits,
                model=dict(alpha=model.alpha, beta=model.beta,
                           gamma=model.gamma), gamma=gamma,
                solves=solves)})
            print(line)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                Path(args.out).write_text(line + "\n")
    finally:
        mesh.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card: the quickest proof that the port builds and runs on the GPU.

  python3 chip_smoke.py

What it does, in order; any failure raises and the exit code is not 0:

1. prints the card (``nvidia-smi`` name and power limit), the torch version
   and the compute capability, which must be (9, 0);
2. turns TF32 off, so every plain PyTorch version is full float32;
3. builds every CUDA kernel from ``src/repro_torch/csrc`` with nvcc (one
   process per source, all at once) into ``build/repro_torch/``;
4. kernel phase: holds each kernel against its plain PyTorch version on the
   card at the main path's shapes (gram sees the augmented data [X; y], so
   d+1 rows), at a ragged shape and (prox_loop) above the shared-memory
   limit, and times kernel, plain version and, for gram, ``torch.bmm``.
   Tolerances are normwise (max |kernel - plain| / max |plain|): 1e-5 for
   the prox kernels; for gram 2e-6 over all of G and 2e-5 over its
   off-diagonal entries against their own largest magnitude, limits that
   float32 sums in m-chunks meet (3e-7 and 1.2e-6 in a float32 model of
   the kernel's summation order) and TF32 products would not (4e-6 and
   3.6e-4 in the same model);
5. main path: ``repro_torch.launch.lasso_solve.main`` with T=256, k=32,
   b=0.1, Q=5 on covtype at full size (CA-SFISTA, SFISTA) and on susy at
   full size (CA-SPNM, SPNM). Each run is read for its kernel launches and
   registry dispatches (zeroed just before it), its relative solution error,
   CA == classical (5e-6) and the card's w against the port's plain solve on
   the card with the same draws and step (1e-4). Then the solve wall of
   each schedule on the same draws: one untimed warm-up solve of each, then
   three timed solves of each in the order CA, classical, classical, CA,
   CA, classical, reported as all six walls and the two medians;
6. a profiled CA and classical covtype solve: device time by kernel and the
   device's busy share of the wall time;
7. prints ``{"kernels": [...]}``, the card's name and power limit, and as
   the last line ``{"ok": true, "device": {...}}``.

With no card, or run from a directory that holds nothing else of the
repository, it exits with an error before printing any result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 FLOP/s
#: outside the tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
#: kernel vs plain version, normwise (see the module docstring)
KERNEL_RTOL = 1e-5
GRAM_RTOL = 2e-6
GRAM_OFFDIAG_RTOL = 2e-5
#: CA vs classical on the card: the reference's own trajectory tolerance
CA_ATOL = 5e-6
#: card vs the port's plain solve with the same draws and step
PLAIN_ATOL = 1e-4
T, K, B, Q = 256, 32, 0.1, 5
VARIANTS = ("l1", "elastic_net", "box", "none")
SCAL = (0.05, 0.02, 0.3, -0.1, 0.2)     # [t, lam, mu, lo, hi]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float):
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and float32 operations over the non-tensor-core peak."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def _self_device_us(ev) -> float:
    """A profiler average's own device time, under either of the names
    torch has given it."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, attr):
            return getattr(ev, attr)
    return 0.0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script needs an NVIDIA Hopper card",
              file=sys.stderr)
        return 1

    from repro_torch import kernels
    from repro_torch.core import sstep
    from repro_torch.core.sampling import sample_index_batch
    from repro_torch.kernels import _build, registry
    from repro_torch.kernels.gram import ops as gram_ops, ref as gram_ref
    from repro_torch.kernels.prox_step import ops as prox_ops
    from repro_torch.kernels.prox_step import ref as prox_ref
    from repro_torch.launch import lasso_solve

    dev = torch.device("cuda")
    card = nvidia_smi()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    cap = torch.cuda.get_device_capability()
    print(f"device: {torch.cuda.get_device_name(0)} capability {cap} "
          f"count {torch.cuda.device_count()}")
    check(cap == (9, 0), f"need compute capability (9, 0), got {cap}")

    # 2. full float32 in every plain version
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 3. build
    t0 = time.perf_counter()
    secs = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f}s "
          + " ".join(f"{s}={v:.2f}s" for s, v in secs.items()))
    for stem in _build.SOURCES:
        for line in _build.build_log(stem).splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas[{stem}] {line.strip()}")
    shared_d, max_d = prox_ops.prox_loop_limits()
    print(f"prox_loop: G in shared memory up to d={shared_d}, "
          f"vectors up to d={max_d}")

    def time_ms(fn, iters):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    def compare(name, shape, got, want, rtol=KERNEL_RTOL):
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name}{shape}: not finite")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        rel = err / max(scale, 1e-30)
        print(f"  {name:9s} {str(shape):22s} max_abs_err={err:.3e} "
              f"normwise_rel={rel:.3e}")
        check(rel <= rtol, f"{name}{shape}: normwise error {rel:.3e} > "
              f"{rtol}")
        return err

    def compare_offdiag(shape, got, want):
        off = ~torch.eye(shape[1], dtype=torch.bool, device=dev)
        err = float((got - want).abs()[:, off].max())
        rel = err / max(float(want.abs()[:, off].max()), 1e-30)
        print(f"  {'gram':9s} {str(shape):22s} off-diagonal "
              f"max_abs_err={err:.3e} normwise_rel={rel:.3e}")
        check(rel <= GRAM_OFFDIAG_RTOL, f"gram{shape}: off-diagonal error "
              f"{rel:.3e} > {GRAM_OFFDIAG_RTOL}")

    gen = torch.Generator(device=dev).manual_seed(0)
    entries = {}   # one per kernel, at its main-path shape, for the JSON line
    timings = []   # every timed shape

    # 4a. gram: the CA block of covtype and of susy at full size, the
    # classical (k=1) draw of each (all with the y row: d+1 rows), and a
    # ragged shape
    print("kernel phase: gram")
    for shape in ((32, 55, 58_101), (32, 19, 500_000), (1, 55, 58_101),
                  (1, 19, 500_000), (3, 61, 129)):
        Xs = torch.randn(*shape, generator=gen, device=dev)
        got = gram_ops.gram_cuda(Xs)
        want = gram_ref.gram(Xs)
        err = compare("gram", shape, got, want, rtol=GRAM_RTOL)
        compare_offdiag(shape, got, want)
        if shape[0] > 1:
            # one draw's G has the same bits alone (classical) as in the batch
            for j in (0, shape[0] - 1):
                check(torch.equal(gram_ops.gram_cuda(Xs[j:j + 1])[0], got[j]),
                      f"gram{shape}: draw {j} alone differs from its batch")
        k, d, m = shape
        if m < 1000:
            continue
        iters = 20 if k > 1 else 200
        ms = time_ms(lambda: gram_ops.gram_cuda(Xs), iters)
        plain = time_ms(lambda: gram_ref.gram(Xs), iters)
        lib = time_ms(lambda: torch.bmm(Xs, Xs.transpose(1, 2)), iters)
        # G is symmetric: d(d+1)/2 distinct entries of 2m FLOP each
        bms, by = bound_ms(4.0 * (k * d * m + k * d * d),
                           1.0 * k * d * (d + 1) * m)
        e = dict(name="gram", route="cuda",
                 source="src/repro_torch/csrc/gram.cu",
                 replaces="src/repro/kernels/gram/kernel.py:44",
                 launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                 bound_ms=bms, bound_by=by, library_ms=lib, shape=list(shape))
        timings.append(e)
        if shape == (32, 55, 58_101):
            entries["gram"] = e
        del Xs, got

    # 4b. prox_step / prox_loop at d = 54 and 18 for each variant, ragged
    # d = 61, and prox_loop at d = 300, above the shared-memory limit
    print("kernel phase: prox_step, prox_loop")
    scal = prox_ops.prox_scalars(*SCAL, device=dev)
    errs = {"prox_step": {}, "prox_loop": {}}
    for d in (54, 18, 61, 300):
        A = torch.randn(d, d, generator=gen, device=dev)
        G = (A @ A.T / d).contiguous()
        R = torch.randn(d, generator=gen, device=dev)
        v = torch.randn(d, generator=gen, device=dev)
        for variant in VARIANTS:
            if d != 300:
                errs["prox_step"][(d, variant)] = compare(
                    "prox_step", (d, variant),
                    prox_ops.prox_step_cuda(G, R, v, scal, variant=variant),
                    prox_ref.prox_step(G, R, v, scal, variant=variant))
            errs["prox_loop"][(d, variant)] = compare(
                "prox_loop", (d, variant, Q),
                prox_ops.prox_loop_cuda(G, R, v, scal, Q=Q, variant=variant),
                prox_ref.prox_loop(G, R, v, scal, Q=Q, variant=variant))
        if d not in (54, 18):
            continue
        nbytes = 4.0 * (d * d + 3 * d + 5)
        for name in ("prox_step", "prox_loop"):
            if name == "prox_step":
                ms = time_ms(lambda: prox_ops.prox_step_cuda(G, R, v, scal), 500)
                plain = time_ms(lambda: prox_ref.prox_step(G, R, v, scal), 500)
                bms, by = bound_ms(nbytes, 2.0 * d * d + 6 * d)
                replaces = "src/repro/kernels/prox_step/kernel.py:89"
            else:
                ms = time_ms(lambda: prox_ops.prox_loop_cuda(G, R, v, scal, Q=Q),
                             500)
                plain = time_ms(lambda: prox_ref.prox_loop(G, R, v, scal, Q=Q),
                                200)
                bms, by = bound_ms(nbytes, Q * (2.0 * d * d + 6 * d))
                replaces = "src/repro/kernels/prox_step/kernel.py:77"
            e = dict(name=name, route="cuda",
                     source="src/repro_torch/csrc/prox_step.cu",
                     replaces=replaces, launches=0,
                     max_abs_err=errs[name][(d, "l1")], ms=ms, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=None,
                     shape=[d] if name == "prox_step" else [d, Q])
            timings.append(e)
            # FISTA runs on covtype (d=54), PNM on susy (d=18)
            if (name, d) in (("prox_step", 54), ("prox_loop", 18)):
                entries[name] = e
    for name in ("prox_step", "prox_loop"):
        print(f"  {name}: max_abs_err over all shapes and variants "
              f"{max(errs[name].values()):.3e}")
    for e in timings:
        print(f"  time {e['name']:9s} {str(e['shape']):18s} kernel={e['ms']:.4f}ms "
              f"plain={e['plain_ms']:.4f}ms library={e['library_ms']} "
              f"bound={e['bound_ms']:.5f}ms ({e['bound_by']})")

    # 5. main path
    print(f"main path: lasso_solve T={T} k={K} b={B} Q={Q}")
    total = {"gram": 0, "prox_step": 0, "prox_loop": 0}
    for dataset, scale, (ca_name, cl_name), rule, n_full in (
            ("covtype", "10", ("ca_sfista", "sfista"), sstep.FISTA_RULE,
             581_010),
            ("susy", "50", ("ca_spnm", "spnm"), sstep.PNM_RULE, 5_000_000)):
        runs = {}
        for algo in (ca_name, cl_name):
            kernels.reset_launch_counts()
            registry.reset_dispatch_counts()
            run = lasso_solve.main([
                "--dataset", dataset, "--scale", scale, "--algorithm", algo,
                "--T", str(T), "--k", str(K), "--b", str(B), "--Q", str(Q),
                "--seed", "0", "--device", "cuda"])
            launches = kernels.launch_counts()
            dispatches = registry.dispatch_counts()
            runs[algo] = run
            ca = algo.startswith("ca_")
            prox = "prox_step" if rule is sstep.FISTA_RULE else "prox_loop"
            print(f"  {dataset} {algo}: n={run.problem.n} d={run.problem.d} "
                  f"rel_err={run.rel_err:.6f} objective={run.objective:.6f} "
                  f"wall={run.seconds:.4f}s launches={launches} "
                  f"dispatches={dispatches}")
            check(run.problem.n == n_full, f"{dataset}: n={run.problem.n}")
            check(launches == run.launches, "launch counts disagree")
            check(all(b == "cuda" for (_, b) in dispatches),
                  f"{algo}: a plain version ran: {dispatches}")
            want_gram = T // K if ca else T
            check(launches["gram"] == want_gram,
                  f"{algo}: gram launched {launches['gram']}, want {want_gram}")
            check(launches[prox] == T,
                  f"{algo}: {prox} launched {launches[prox]}, want {T}")
            check(math.isfinite(run.rel_err) and run.rel_err < 1.0,
                  f"{algo}: rel_err {run.rel_err}")
            for op in total:
                total[op] += launches[op]
        ca_run, cl_run = runs[ca_name], runs[cl_name]
        check(ca_run.step == cl_run.step, "CA and classical step sizes differ")
        diff = float((ca_run.w - cl_run.w).abs().max())
        print(f"  {dataset}: |w_{ca_name} - w_{cl_name}|_max = {diff:.3e}")
        check(diff <= CA_ATOL, f"{dataset}: CA vs classical {diff:.3e} > "
              f"{CA_ATOL}")
        # the port's plain solve on the card, same draws and step
        problem, cfg = cl_run.problem, cl_run.cfg
        draws = sample_index_batch(
            torch.Generator(device=dev).manual_seed(0), cfg.T, problem.n,
            sstep.draw_size(problem, cfg))
        with registry.use("torch"):
            w_plain = sstep.solve(problem, cfg, None, rule, name="plain",
                                  ca=False, idx=draws)
        for algo, run in runs.items():
            diff = float((run.w - w_plain).abs().max())
            print(f"  {dataset}: |w_{algo} - w_plain|_max = {diff:.3e}")
            check(diff <= PLAIN_ATOL, f"{dataset} {algo}: vs plain "
                  f"{diff:.3e} > {PLAIN_ATOL}")

        def timed_solve(ca):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sstep.solve(problem, cfg, None, rule, name="timed", ca=ca,
                        idx=draws)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        timed_solve(True)    # warm-up, untimed: first use of these shapes
        timed_solve(False)
        walls = {True: [], False: []}
        for ca in (True, False, False, True, True, False):
            walls[ca].append(timed_solve(ca))
        med = {ca: sorted(w)[1] for ca, w in walls.items()}
        print(f"  {dataset}: warm solve wall, median of 3: {ca_name} "
              f"{med[True]!r}s {walls[True]!r}, {cl_name} {med[False]!r}s "
              f"{walls[False]!r}, classical/CA {med[False] / med[True]!r}")
        if dataset == "covtype":
            covtype = (problem, cfg, draws)
        del runs, ca_run, cl_run, problem, w_plain

    for name, e in entries.items():
        e["launches"] = total[name]
        check(total[name] > 0, f"{name} was not launched on the main path")

    # 6. where the time goes: one profiled CA and classical covtype solve
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    problem, cfg, draws = covtype
    for ca in (True, False):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sstep.solve(problem, cfg, None, sstep.FISTA_RULE, name="profiled",
                        ca=ca, idx=draws)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(ev.key, _self_device_us(ev), ev.count)
                for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows) / 1e6
        print(f"profile covtype {'ca_sfista' if ca else 'sfista'}: wall "
              f"{wall:.4f}s (profiled), device kernels {busy:.4f}s "
              f"({100 * busy / wall:.1f}% busy), {len(rows)} kernel names")
        for key, us, count in rows[:8]:
            print(f"    {us / 1e3:10.3f} ms  x{count:<5d} {key[:90]}")

    print(json.dumps({"kernels": [
        {k: v for k, v in e.items() if k != "shape"}
        for e in entries.values()]}))
    print(f"card: {nvidia_smi()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

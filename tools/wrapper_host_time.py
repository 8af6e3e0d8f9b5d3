"""Host time of one call of each kernel the CA Lasso solves launch, at
their main-path shapes: what the host spends to enqueue it, through the
op registry (``registry.dispatch``, as the solvers call it) and through
the wrapper alone.

  python tools/wrapper_host_time.py                     # this checkout
  python tools/wrapper_host_time.py --src OTHER/src     # another tree

``--src`` puts another tree's ``src`` first on the path, so one call on
the card can time two trees in turn (A, B, B, A) with the same script;
each tree builds its kernels into its own ``build/``. The shapes are the
covtype CA block (k = 32 draws of m = 58,101 of n = 581,010 rows, d = 54)
for ``gram_gather``, ``prox_step_block`` and ``pdhg_block``, and the susy
block (d = 18, Q = 5) for ``prox_loop_block``; the operands are seeded
random data (the values do not change the host's work). A round is
``--iters`` calls with no synchronize inside, between two synchronizes;
the time is the median of ``--rounds`` rounds. Prints the card's name and
power limit and the line ``{"wrapper_host_us": {...}}``. It imports no
JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _host_us(fn, iters: int, rounds: int) -> float:
    import torch
    fn()
    per = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        per.append((time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    import repro_torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.prox_step import ops as prox_ops

    if not torch.cuda.is_available():
        print("wrapper_host_time: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    n, m, k, d, ds, Q = 581_010, 58_101, 32, 54, 18, 5
    rows = rand(n, 56)                                  # r = 55, padded
    idx = torch.randint(0, n, (k, m), generator=gen, device=dev)
    G, R, w, u = rand(k, d, d), rand(k, d), rand(d), rand(d)
    Gs, Rs, zs = rand(ds, ds).expand(k, ds, ds).contiguous(), rand(k, ds), \
        rand(ds)
    scal = torch.tensor([0.1, 0.01, 0.0, -1e30, 1e30], device=dev)
    sigma = torch.tensor([0.5], device=dev)
    calls = {
        "gram_gather": (("gram_gather", rows, idx, 55, 1.0 / m), {},
                        lambda: gram_ops.gram_gather_cuda(rows, idx, 55,
                                                          1.0 / m)),
        "prox_step_block": (("prox_step_block", G, R, w, w, scal),
                            dict(j0=1),
                            lambda: prox_ops.prox_step_block_cuda(
                                G, R, w, w, scal, j0=1)),
        "prox_loop_block": (("prox_loop_block", Gs, Rs, zs, scal),
                            dict(Q=Q),
                            lambda: prox_ops.prox_loop_block_cuda(
                                Gs, Rs, zs, scal, Q=Q)),
        "pdhg_block": (("pdhg_block", G, R, w, u, scal, sigma), {},
                       lambda: prox_ops.pdhg_block_cuda(G, R, w, u, scal,
                                                        sigma)),
    }
    out = dict(tree=str(Path(args.src).resolve()),
               package=str(Path(repro_torch.__file__).resolve().parent),
               iters=args.iters, rounds=args.rounds, dispatch={},
               wrapper={})
    with registry.use("cuda"):
        for name, (a, kw, wrapper) in calls.items():
            out["dispatch"][name] = _host_us(
                lambda: registry.dispatch(*a, **kw), args.iters, args.rounds)
            out["wrapper"][name] = _host_us(wrapper, args.iters, args.rounds)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()
    for name in calls:
        print(f"{name:16s} dispatch {out['dispatch'][name]:7.2f} us, "
              f"wrapper {out['wrapper'][name]:7.2f} us a call "
              f"({out['package']})")
    print(json.dumps({"wrapper_host_us": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

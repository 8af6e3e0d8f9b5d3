"""The distributed CA solvers as the paper runs them (Algorithm V): X
column-partitioned over the ranks of a process group, per-rank sampling,
one all-reduce of the Gram statistics every k iterations, and the PDHG and
BCD pairs through the same path. All eight algorithms, one after the other.

  torchrun --nproc-per-node 4 -m repro_torch.launch.distributed_lasso
  PYTHONPATH=src python -m repro_torch.launch.distributed_lasso --device cpu

Under ``torchrun`` each rank takes a card (``nccl``), or a CPU core with
``--device cpu`` (``gloo``); without it the process runs alone in a group
of one. Every rank builds the same seeded problem and takes its column
block. Rank 0 prints, for each algorithm, the relative solution error, the
all-reduces the run made (T/k for CA, T classical) and the words they
moved, and the solve's wall time.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.core import (SolverConfig, relative_solution_error,
                              solve_reference)
from repro_torch.core.distributed import (ALGORITHMS, CollectiveCount,
                                          make_distributed_solver,
                                          shard_problem)
from repro_torch.data import make_dataset_like
from repro_torch.launch import mesh


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="covtype",
                    choices=["abalone", "covtype", "susy"])
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--T", type=int, default=128)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--b", type=float, default=0.05)
    ap.add_argument("--Q", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if "RANK" in os.environ:
        device = mesh.init(args.device)
    else:
        device = mesh.init(args.device, rank=0, world_size=1)
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        problem, _ = make_dataset_like(args.dataset, scale=args.scale,
                                       device=device)
        X_local, y_local = shard_problem(problem.X, problem.y, rank, world)
        base = SolverConfig(T=args.T, k=args.k, b=args.b, Q=args.Q)
        t = problem.default_step(base)
        w_opt = solve_reference(problem)
        if rank == 0:
            print(f"world {world} ({device.type}), problem: d={problem.d} "
                  f"n={problem.n}, {X_local.shape[1]} samples a rank")
        results = {}
        for alg in ALGORITHMS:
            count = CollectiveCount()
            solve = make_distributed_solver(alg, base, problem.lam,
                                            counter=count)
            w0 = torch.zeros(problem.d, device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            w = solve(X_local, y_local, w0, t, gen=args.seed)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            err = float(relative_solution_error(w, w_opt))
            results[alg] = dict(rel_err=err, all_reduces=count.all_reduces,
                                words=count.words, seconds=wall)
            if rank == 0:
                n = count.all_reduces
                print(f"{alg:10s} rel_err={err:.4f}  all-reduces/run={n:4d} "
                      f"({n / args.T:.2f} per iteration), "
                      f"words={count.words}, wall={wall:.4f}s")
        return results
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main()

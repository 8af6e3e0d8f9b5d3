"""LASSO solver launcher — the paper's workload on the card.

  PYTHONPATH=src python -m repro_torch.launch.lasso_solve --dataset covtype \
      --scale 10 --algorithm ca_sfista --k 32 --b 0.1 --T 256

The flags and defaults are the JAX launcher's (``repro.launch.lasso_solve``)
for its eight solvers, plus ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain versions on the CPU). ``--scale 10`` is covtype at its
full 581,010 rows and ``--scale 50`` susy at 5,000,000.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, NamedTuple

import torch

from repro_torch import kernels, resolve_device
from repro_torch.core import (SolverConfig, sfista, ca_sfista, spnm, ca_spnm,
                              pdhg, ca_pdhg, bcd, ca_bcd, solve_reference,
                              relative_solution_error, lasso_objective)
from repro_torch.core.cost_model import CostModel, MachineParams
from repro_torch.core.problem import LassoProblem
from repro_torch.data import make_dataset_like

SOLVERS = dict(sfista=sfista, ca_sfista=ca_sfista, spnm=spnm, ca_spnm=ca_spnm,
               pdhg=pdhg, ca_pdhg=ca_pdhg, bcd=bcd, ca_bcd=ca_bcd)


class Run(NamedTuple):
    """What one ``main`` call solved and how."""
    w: torch.Tensor
    #: kernel launches per op during the solve
    launches: Dict[str, int]
    problem: LassoProblem
    cfg: SolverConfig
    #: the step size t the solver used (host float, read after the solve)
    step: float
    iters: int
    rel_err: float
    objective: float
    #: wall seconds of the solve, ending in a device synchronize
    seconds: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> Run:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="covtype",
                    choices=["abalone", "covtype", "susy"])
    ap.add_argument("--algorithm", default="ca_sfista",
                    choices=sorted(SOLVERS))
    ap.add_argument("--T", type=int, default=256)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--b", type=float, default=0.1)
    ap.add_argument("--Q", type=int, default=5)
    ap.add_argument("--scale", type=float, default=0.1,
                    help="dataset size fraction (10: covtype at full size, "
                         "50: susy at full size)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tol", type=float, default=None,
                    help="stop at relative solution error <= tol (paper's "
                         "second stopping criterion); runs in k-sized rounds")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    problem, _ = make_dataset_like(args.dataset, scale=args.scale,
                                   device=device)
    cfg = SolverConfig(T=args.T, k=args.k, b=args.b, Q=args.Q)
    solver = SOLVERS[args.algorithm]
    gen = torch.Generator(device=device).manual_seed(args.seed)

    w_opt = solve_reference(problem)
    step = float(problem.default_step(cfg))
    cfg = SolverConfig(T=args.T, k=args.k, b=args.b, Q=args.Q,
                       step_size=step)
    before = kernels.launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    if args.tol is not None:
        # paper §V-A stopping criterion (ii): run until rel err <= tol,
        # checking once per k-step round (checking costs one extra wait)
        w = torch.zeros(problem.d, device=device)
        total = 0
        cfg_round = SolverConfig(T=args.k, k=args.k, b=args.b, Q=args.Q,
                                 step_size=step)
        while total < args.T:
            w = solver(problem, cfg_round, gen, w0=w)
            total += args.k
            if float(relative_solution_error(w, w_opt)) <= args.tol:
                break
        iters = total
    else:
        w = solver(problem, cfg, gen)
        iters = cfg.T
    _sync(device)
    dt = time.perf_counter() - t0
    after = kernels.launch_counts()
    launches = {op: after[op] - before[op] for op in after}

    err = float(relative_solution_error(w, w_opt))
    obj = float(lasso_objective(problem, w))
    print(f"dataset={args.dataset} d={problem.d} n={problem.n} "
          f"lambda={problem.lam:.5f} device={device}")
    print(f"{args.algorithm}: iters={iters} rel_err={err:.5f} "
          f"objective={obj:.6f} wall={dt:.3f}s")
    nnz = int((torch.abs(w) > 1e-6).sum())
    print(f"solution support: {nnz}/{problem.d}")
    # on the card: gram_gather and the rule's block prox kernel
    # (prox_step_block for FISTA, prox_loop_block for PNM, pdhg_block for
    # PDHG), T/k launches each for CA, T for classical; for BCD, gram T/k or
    # T times; none on the CPU (plain versions)
    print("kernel launches: " + (" ".join(
        f"{op}={n}" for op, n in launches.items() if n) or "none"))
    cm = CostModel(d=problem.d, n=problem.n, b=args.b, T=iters, k=args.k)
    for P in (64, 1024):
        print(f"  predicted CA speedup at P={P} (Comet model): "
              f"{cm.speedup(P, MachineParams.comet_like()):.2f}x")
    return Run(w=w, launches=launches, problem=problem, cfg=cfg, step=step,
               iters=iters, rel_err=err, objective=obj, seconds=dt)


if __name__ == "__main__":
    main()

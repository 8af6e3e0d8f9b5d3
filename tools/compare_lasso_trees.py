"""Two checkouts of this repository on one card: the port's Lasso solves of
each, in the order OTHER, THIS, THIS, OTHER, one process a run.

  python tools/compare_lasso_trees.py OTHER_TREE [--out DIR]

OTHER_TREE is another commit's tree (for a parent:
``git archive <commit> | tar -x -C build/parent``). Each run builds that
tree's kernels (``gram``, ``prox_step``) into its own ``build/``, solves
covtype (581,010 rows) with CA-SFISTA and SFISTA and susy (5,000,000 rows)
with CA-SPNM and SPNM at T=256, k=32, b=0.1, Q=5, the draws from seed 0 as
``lasso_solve`` takes them, and prints the warm solve walls and a profiled
CA and classical solve of each dataset, both by ``chip_smoke.py``'s phase 5
and 6 functions (``solve_walls``, ``profile_solve``) run on the other
tree's solvers. Last, it prints whether each solver's w is bit-identical
across all four runs. It needs a CUDA card and imports no JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parents[1]
SOLVES = (("covtype", 10, ("ca_sfista", "sfista"), "fista"),
          ("susy", 50, ("ca_spnm", "spnm"), "pnm"))


def run_tree(tree: Path, out: Path) -> None:
    """One run: the solves of ``tree``, its w's saved to ``out``."""
    sys.path.insert(0, str(THIS))
    import chip_smoke      # puts THIS/src on the path; ``tree``'s goes first
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch import core as tcore
    from repro_torch.core import sstep
    from repro_torch.core.problem import SolverConfig
    from repro_torch.core.sampling import sample_index_batch
    from repro_torch.data import make_dataset_like
    from repro_torch.kernels import _build
    assert Path(sstep.__file__).resolve().is_relative_to(tree.resolve())
    dev = torch.device("cuda")
    tag = f"[{tree}]"
    print(tag, "build", _build.build(["gram", "prox_step"]), flush=True)
    ws = {}
    for dataset, scale, pair, rule in SOLVES:
        problem, _ = make_dataset_like(dataset, scale=scale, device=dev)
        step = float(problem.default_step(SolverConfig(T=256, k=32, b=0.1,
                                                       Q=5)))
        cfg = SolverConfig(T=256, k=32, b=0.1, Q=5, step_size=step)
        for algo in pair:
            gen = torch.Generator(device=dev).manual_seed(0)
            ws[algo] = getattr(tcore, algo)(problem, cfg, gen).cpu()
        draws = sample_index_batch(torch.Generator(device=dev).manual_seed(0),
                                   cfg.T, problem.n,
                                   sstep.draw_size(problem, cfg))
        med, walls = chip_smoke.solve_walls(problem, cfg, sstep.RULES[rule],
                                            draws)
        print(f"{tag} {dataset}: warm wall, median of 3: {pair[0]} "
              f"{med[True]!r} s {walls[True]!r}, {pair[1]} {med[False]!r} "
              f"s {walls[False]!r}, classical/CA "
              f"{med[False] / med[True]!r}", flush=True)
        for ca in (True, False):
            wall, rows = chip_smoke.profile_solve(problem, cfg,
                                                  sstep.RULES[rule], draws, ca)
            busy = sum(r[1] for r in rows) / 1e3
            print(f"{tag} profile {pair[0] if ca else pair[1]}: wall "
                  f"{wall * 1e3:.3f} ms, kernels {busy:.3f} ms "
                  f"({100 * busy / (wall * 1e3):.1f}% busy), "
                  f"{sum(r[2] for r in rows)} launches")
            for key, us, count in rows[:6]:
                print(f"    {us / 1e3:9.3f} ms x{count:<5d} {key[:80]}")
        del problem, draws
        torch.cuda.empty_cache()
    torch.save(ws, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path, help="the other commit's tree")
    ap.add_argument("--out", type=Path, default=THIS / "build" / "compare")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.run is not None:   # one run, in its own process
        run_tree(args.other, args.run)
        return 0
    args.out.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, (name, tree) in enumerate((("other", args.other), ("this", THIS),
                                      ("this", THIS), ("other", args.other))):
        out = args.out / f"w_{i}_{name}.pt"
        subprocess.run([sys.executable, __file__, str(tree), "--run",
                        str(out)], check=True, timeout=900)
        runs.append(out)
    import torch
    ws = [torch.load(f) for f in runs]
    for algo in ws[0]:
        same = all(torch.equal(ws[0][algo], w[algo]) for w in ws)
        diff = max(float((ws[0][algo] - w[algo]).abs().max()) for w in ws)
        print(f"{algo}: w bit-identical across the four runs: {same} "
              f"(max |diff| {diff:.3e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

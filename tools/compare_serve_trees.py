"""Two checkouts of this repository on one card: phase 9's paged engine of
each (internlm2-1.8b at full width, 8 slots, max_len 1024, page 16, k=8,
obs off), in the order OTHER, THIS, THIS, OTHER, one process a run.

  python tools/compare_serve_trees.py OTHER_TREE

OTHER_TREE is another commit's tree (for a parent:
``git archive <commit> | tar -x -C build/parent``). Each run builds that
tree's ``flash_attention`` source into its own ``build/``, serves 16
numpy-seeded requests (prompts of 32-128 tokens, 32 new tokens each) and
prints the steady ms/step (after the first block); the runs' results go to
``chiprun_out/serve_cmp_<i>.json``. Last, it prints whether the token
streams are bit-identical across all four runs. It needs a CUDA card and
imports no JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

THIS = Path(__file__).resolve().parents[1]


def run_tree(tree: str, out: str) -> None:
    """One run: the engine of ``tree``, its streams and ms/step to
    ``out``."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import init_params
    from repro_torch.serve import Engine, Request
    import repro_torch.serve.engine as engine_mod
    assert Path(engine_mod.__file__).resolve().is_relative_to(
        Path(tree).resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(tree, "build", _build.build(["flash_attention"]), flush=True)
    dev = torch.device("cuda")
    cfg = get_arch("internlm2-1.8b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev)
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(16):
        plen = int(rng.randint(32, 129))
        reqs.append(Request(id=f"req-{i}",
                            prompt=rng.randint(0, cfg.vocab,
                                               size=plen).tolist(),
                            max_new_tokens=32))
    eng = Engine(params, cfg, num_slots=8, max_len=1024, max_prompt=512,
                 k=8, page_size=16, eos_id=None, device=dev, sync_debug=True)
    for r in reqs:
        eng.submit(r)
    out_r = eng.step()                   # first block: allocator warm-up
    torch.cuda.synchronize()
    s0 = eng.stats.steps
    t0 = time.perf_counter()
    out_r += eng.run()
    wall = time.perf_counter() - t0
    ms = wall / (eng.stats.steps - s0) * 1e3
    print(f"{tree}: steady {ms:.3f} ms/step over {eng.stats.steps - s0} "
          f"steps, syncs {eng.stats.syncs}", flush=True)
    with open(out, "w") as f:
        json.dump({"ms_per_step": ms,
                   "streams": {r.id: r.tokens for r in out_r}}, f)


def main() -> int:
    if len(sys.argv) == 3:
        run_tree(sys.argv[1], sys.argv[2])
        return 0
    other = sys.argv[1]
    out_dir = THIS / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    res = []
    for i, tree in enumerate((other, str(THIS), str(THIS), other)):
        out = out_dir / f"serve_cmp_{i}.json"
        subprocess.run([sys.executable, __file__, tree, str(out)],
                       check=True)
        res.append((tree, json.loads(out.read_text())))
    streams = [r["streams"] for _, r in res]
    print("streams bit-identical across all four runs:",
          all(s == streams[0] for s in streams))
    print("ms/step:", [(t, round(r["ms_per_step"], 3)) for t, r in res])
    return 0


if __name__ == "__main__":
    sys.exit(main())

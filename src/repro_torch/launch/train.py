"""Training driver: the CA train step, sharded over a
``torch.distributed`` group's mesh when launched by ``torchrun``, the
fault-tolerant runner, checkpoints and the restartable token stream (the
counterpart of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --preset tiny --steps 12 --ckpt-every 4 --fail-at 6 \\
      --ckpt-dir "$(mktemp -d)"
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --device cpu --preset tiny --steps 12 --ckpt-dir "$(mktemp -d)"

With ``RANK`` and ``WORLD_SIZE`` set (``torchrun``) every rank joins the
default group (``launch.mesh.init``: nccl on the card, gloo with
``--device cpu``; a process already in one keeps it) and the job trains on
the mesh JAX's CLI picks for the world (``launch.mesh.make_host_mesh``:
the model axis 4, 2 or 1 ranks, the first that divides it; a family the
port does not split over the model axis yet gets the data-only mesh), its
state sharded by JAX's specs (``launch.steps.make_train_step``). Rank 0
prints the mesh, every rank its shard bytes and the step's collectives;
the job checkpoints its global leaves in the one ``--ckpt-dir``. Without
them it trains on one device and makes no collective. The run resumes from the newest checkpoint in ``--ckpt-dir``
(default ``$TMPDIR/repro_torch_ckpt``), so a fresh run needs an empty
directory.

Flags as in JAX: ``--arch`` (the token-only families: dense, moe, ssm and
hybrid; whisper and qwen2-vl need their frame and patch embeddings, which
the token stream does not make: ``repro_torch.launch.grad_smoke`` trains
them, as JAX's CLI refuses them too),
``--preset`` (tiny: the smoke config at batch 8, seq 64; 100m: 6 layers of
width 1024 at batch max(ca_k, 8), seq 512; full: the published widths at
batch 8 * ca_k, seq 1024), ``--steps``, ``--ca-k``, ``--lr``, ``--ckpt-dir``, ``--ckpt-every``,
``--fail-at``, ``--log-every``, ``--metrics [PATH]`` and ``--trace-out
PATH`` (``repro_torch.obs``), plus ``--device`` (default ``cuda``, raising
on a host with no card). Weights are float32 masters from a seeded
``torch.Generator``. Autotune comes with its ROADMAP item.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import get_arch, smoke_config
from repro_torch.data import TokenStream
from repro_torch.core.distributed import CollectiveCount
from repro_torch.dist import FailureSource, TrainingRunner, make_rules
from repro_torch.launch import mesh
from repro_torch.launch.obs_cli import add_obs_args, obs_begin, obs_end
from repro_torch.launch.steps import (init_train_state, layout,
                                      make_train_step)
from repro_torch.models.transformer import require_supported


def build(args):
    """(cfg, batch, seq) of a preset, as ``repro.launch.train.build``."""
    arch = get_arch(args.arch)
    if args.preset == "tiny":
        cfg = smoke_config(arch)
        batch, seq = 8, 64
    elif args.preset == "100m":
        cfg = arch.scaled(n_layers=6, d_model=1024,
                          n_heads=8, n_kv_heads=max(arch.n_kv_heads // 4, 1),
                          head_dim=128, d_ff=4096, vocab=32000)
        batch, seq = max(args.ca_k, 8), 512
    else:
        cfg = arch
        batch, seq = 8 * args.ca_k, 1024
    return cfg, batch, seq


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--preset", choices=["tiny", "100m", "full"],
                    default="tiny")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ca-k", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject node failures at these steps (FT demo)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="device to run on (default cuda; raises on a host "
                         "with no card unless this says cpu)")
    add_obs_args(ap)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, batch, seq = build(args)
    require_supported(cfg)
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: the token stream trains the token-only families; "
            f"{cfg.family!r} needs its embeddings: train it through "
            f"repro_torch.launch.grad_smoke")
    distributed = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    joined = distributed and not dist.is_initialized()
    rules, count = None, CollectiveCount()
    if distributed:
        if joined:
            device = mesh.init(device.type)
        host = mesh.make_host_mesh(
            tensor_parallel=cfg.family == "dense")
        rules = make_rules(host, dist.group.WORLD)
        rank = dist.get_rank()
        if rank == 0:
            print(f"mesh (data, model) = {host.sizes} over {rules.n_devices}"
                  f" ranks" + ("" if cfg.family == "dense" else
                              f" (data only: the {cfg.family!r} family is "
                              f"not split over the model axis yet)"))

    calls = [0]

    def step_builder(rules_):
        step = make_train_step(cfg, rules_, ca_k=args.ca_k, peak_lr=args.lr,
                               warmup=10, total_steps=args.steps, remat=True,
                               counter=count)

        def counted(state, batch):
            calls[0] += 1
            return step(state, batch)
        return counted

    def data_factory(start_step):
        return TokenStream(batch=batch, seq=seq, vocab=cfg.vocab, seed=0,
                           start_step=start_step, device=device)

    def init_state(rules_=None):
        gen = torch.Generator(device=device).manual_seed(0)
        return init_train_state(cfg, gen, device=device, rules=rules_)

    runner = TrainingRunner(
        step_builder, rules, data_factory, init_state, args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        failure_source=FailureSource(args.fail_at),
        layout=None if rules is None else lambda r: layout(cfg, r))

    observing = obs_begin(args)
    t0 = time.time()
    try:
        runner.run(args.steps)
    finally:
        obs_end(args, observing)
        if joined:
            mesh.shutdown()
    dt = time.time() - t0
    if distributed:
        ran = max(calls[0], 1)
        print(f"rank {rank} at {runner.rules.coords} of mesh "
              f"{runner.rules.mesh.sizes}: shard "
              f"{layout(cfg, runner.rules).shard_bytes()} bytes of float32 "
              f"masters (and as much for each moment); collectives a step: "
              f"{count.all_gathers / ran:g} all_gather, "
              f"{count.reduce_scatters / ran:g} reduce_scatter, "
              f"{count.all_reduces / ran:g} all_reduce, "
              f"{count.words / ran:.0f} words")
    for m in runner.metrics_log[::args.log_every]:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.3f}  lr {m['lr']:.2e}")
    if runner.metrics_log:
        last = runner.metrics_log[-1]
        print(f"step {last['step']:5d}  loss {last['loss']:.4f}  (final)")
    else:
        print(f"checkpoint in {args.ckpt_dir} already at step "
              f"{args.steps}; nothing to do")
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({args.steps / dt:.2f} steps/s), restarts={runner.restarts}")
    return runner


if __name__ == "__main__":
    main()

"""Training smoke: one ``loss_fn`` and its grads per model family (the
counterpart of ``repro.launch.grad_smoke``).

A kernel landing without a working backward, or a registration that
reroutes training to a plain version, fails fast here rather than deep
inside a full-width run. On the card the script first asserts that the
differentiable entry points the models call (``FlashAttentionFn`` through
``kernels.flash_attention.ops.flash_attention``, ``SSDFn`` through
``kernels.ssd.ops.ssd``) select and run the CUDA ``flash_attention``,
``flash_dq``, ``flash_dkv``, ``ssd`` and ``ssd_bwd`` (no plain version),
then counts each family's backward launches.

    PYTHONPATH=src python -m repro_torch.launch.grad_smoke --device cpu
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import torch

from repro_torch import kernels, resolve_device
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.kernels import registry
from repro_torch.models import init_params, loss_fn
from repro_torch.tree import leaves

#: the ops a training step runs through the two autograd Functions
GRAD_OPS = ("flash_attention", "flash_dq", "flash_dkv", "ssd", "ssd_bwd")


def smoke_batch(cfg, gen: torch.Generator, batch: int, seq: int, device):
    """A family's batch from ``gen``: tokens and labels (B, seq); audio:
    ``enc_embeds`` (B, seq, d) and ``dec_len`` tokens; vlm:
    ``vision_embeds`` (B, vision_patches, d) and seq - vision_patches
    tokens. Embeddings normal, in bf16."""
    def tok(n):
        return torch.randint(0, cfg.vocab, (batch, n), generator=gen,
                             device=device, dtype=torch.int32)

    def embeds(n):
        return torch.randn(batch, n, cfg.d_model, generator=gen,
                           device=device).to(torch.bfloat16)
    if cfg.family == "audio":
        return dict(enc_embeds=embeds(seq), tokens=tok(cfg.dec_len),
                    labels=tok(cfg.dec_len))
    if cfg.family == "vlm":
        txt = seq - cfg.vision_patches
        return dict(vision_embeds=embeds(cfg.vision_patches),
                    tokens=tok(txt), labels=tok(txt))
    return dict(tokens=tok(seq), labels=tok(seq))


def family_archs():
    """One (smallest-by-name) arch per family, deterministic order."""
    picked = {}
    for name in sorted(ARCHS):
        picked.setdefault(ARCHS[name].family, name)
    return [picked[f] for f in sorted(picked)]


def assert_cuda_backward_selected(device) -> None:
    """The CUDA impls of the training ops are what ``registry.select``
    picks, and a forward and backward through ``FlashAttentionFn`` and
    ``SSDFn`` dispatch them and nothing else (raises SystemExit)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd.ops import ssd

    gen = torch.Generator(device=device).manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=device).to(
            dtype).requires_grad_()
    q, k, v = rand(1, 32, 4, 16), rand(1, 32, 2, 16), rand(1, 32, 2, 16)
    x, B, C = rand(1, 64, 2, 16), rand(1, 64, 16), rand(1, 64, 16)
    dt = torch.rand(1, 64, 2, generator=gen, device=device).requires_grad_()
    A = (-torch.arange(1, 3, dtype=torch.float32, device=device)
         ).requires_grad_()
    for op, args in (("flash_attention", (q, k, v)),
                     ("ssd", (x, dt, A, B, C))):
        impl = registry.select(op, *args)
        if impl.backend != "cuda":
            raise SystemExit(f"{op}: training would not run the CUDA kernel "
                             f"(selected {impl.backend})")
    registry.reset_dispatch_counts()
    o = flash_attention(q, k, v)
    y, _ = ssd(x, dt, A, B, C, chunk=64)
    torch.autograd.grad((o.float().sum(), y.float().sum()),
                        (q, k, v, x, dt, A, B, C))
    counts = registry.dispatch_counts()
    missing = [op for op in GRAD_OPS if not counts.get((op, "cuda"))]
    plain = [key for key in counts if key[1] != "cuda"]
    if missing or plain:
        raise SystemExit(f"the autograd Functions did not run the CUDA "
                         f"kernels: missing {missing}, plain {plain} "
                         f"({counts})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="device to run on (default cuda; raises on a host "
                         "with no card unless this says cpu)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    backend = registry.resolved_backend(device)
    print(f"# grad smoke: device={device} backend={backend} "
          f"(policy={registry.policy()!r})")
    if backend == "cuda":
        assert_cuda_backward_selected(device)

    gen = torch.Generator(device=device).manual_seed(0)
    failed = []
    for name in family_archs():
        cfg = smoke_config(ARCHS[name])
        params = init_params(cfg, gen, dtype=torch.float32, device=device)
        batch = smoke_batch(cfg, gen, args.batch, args.seq, device)
        ps = [t.requires_grad_() for t in leaves(params)]
        before = kernels.launch_counts()
        t0 = time.time()
        loss = loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, ps)
        loss, gnorm = torch.stack([loss.detach(), torch.sqrt(sum(
            torch.dot(g.reshape(-1), g.reshape(-1)) for g in grads))
        ]).tolist()
        launches = {op: n - before[op]
                    for op, n in kernels.launch_counts().items()
                    if n > before[op]}
        ok = math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0
        if backend == "cuda":
            # each family's backward ran its kernels
            want = {"ssm": ("ssd_bwd",), "hybrid": ("ssd_bwd", "flash_dq")
                    }.get(cfg.family, ("flash_dq", "flash_dkv"))
            ok = ok and all(launches.get(op) for op in want)
        print(f"{name:<18} family={cfg.family:<7} loss={loss:.4f} "
              f"gnorm={gnorm:.3e} dt={time.time() - t0:.1f}s launches="
              f"{launches} {'OK' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
    if failed:
        print(f"# FAILED: {failed}", file=sys.stderr)
        return 1
    print("# all families differentiate under this backend")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

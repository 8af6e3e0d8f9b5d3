"""Serving driver: a thin CLI over the continuous-batching engine
(``repro_torch.serve``), with the classic whole-batch loop kept as
``--engine off`` (the counterpart of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --preset tiny --page-size 5

Engine mode drains a synthetic request stream through
``repro_torch.serve.Engine`` (k decode steps per host sync); the prompts
are drawn with numpy exactly as the JAX CLI draws them. Classic mode
decodes one fixed batch with a host round trip per token. Both report the
first round (one-time set-up: kernel builds, allocator warm-up) and the
steady state separately. Weights are random, from a seeded
``torch.Generator``, held in bf16.

Flags, those of the JAX CLI: ``--arch`` (every arch, engine or classic),
``--preset``, ``--batch``, ``--new-tokens``, ``--max-len``, ``--k``,
``--requests``, ``--engine``, ``--stream`` (print each request's token
deltas as the blocks land), ``--temperature``/``--top-p``/``--top-k``/
``--sample-seed`` (sampled decode; request i seeds ``sample_seed + i``),
``--n`` (fan each request into n sampled streams), ``--page-size``,
``--kv-dtype``, ``--prefix-cache``, ``--overlap`` (the double-buffered
loop), ``--metrics [PATH]`` and ``--trace-out PATH`` (``repro_torch.obs``:
Prometheus text at exit, to PATH or stdout, and a Chrome-trace span
timeline), plus ``--device`` (default ``cuda``, raising on a host with no
card). whisper's requests carry seeded frame embeddings (``enc_len`` =
``--max-len``). The JAX CLI's ``--autotune`` has no counterpart (the port
has no autotuner).

Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) every rank joins the
default group (``launch.mesh.init``: nccl on the card, gloo with
``--device cpu``) and the engine serves on the mesh JAX's CLI builds
(``make_rules(make_host_mesh(), group)``): the dense family
tensor-parallel at (1, world) for a world of 1, 2 or 4 (its weights the
rank's shards, its pool the rank's rows of every page or slot), the other
families on the data-only mesh, which the engine refuses (ROADMAP queue 1
item 7(d), as is a dense world past 4, whose mesh has a data axis). Every
rank serves the same requests; rank 0 prints.

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --device cpu --preset tiny --page-size 4
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import get_arch, smoke_config
from repro_torch.dist import make_rules
from repro_torch.launch import mesh
from repro_torch.launch.obs_cli import add_obs_args, obs_begin, obs_end
from repro_torch.launch.steps import make_serve_step, serve_params
from repro_torch.models import init_cache, init_params, prefill_audio_cache
from repro_torch.serve import Engine, Request, SamplingParams


def _synthetic_requests(cfg, n: int, max_prompt: int, new_tokens: int,
                        enc_len: int, seed: int = 0, sampling=None,
                        fanout: int = 1):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.randint(1, max_prompt + 1))
        prompt = rng.randint(0, cfg.vocab, size=plen).tolist()
        enc = rng.randn(enc_len, cfg.d_model).astype(np.float32) \
            if cfg.family == "audio" else None
        sp = None
        if sampling is not None:
            # distinct per-request seeds derived from the CLI seed
            sp = dataclasses.replace(sampling, seed=(sampling.seed or 0) + i)
        reqs.append(Request(id=f"req-{i}", prompt=prompt,
                            max_new_tokens=new_tokens, enc_embeds=enc,
                            sampling=sp, n=fanout))
    return reqs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _params(cfg, device: torch.device):
    gen = torch.Generator(device=device).manual_seed(0)
    return init_params(cfg, gen, dtype=torch.bfloat16, device=device)


def _cli_sampling(args):
    if args.temperature <= 0.0:
        return None
    return SamplingParams(temperature=args.temperature, top_p=args.top_p,
                          top_k=args.top_k, seed=args.sample_seed)


def serve_stream(cfg, engine, reqs, args):
    """Streamed drain: print token deltas as each k-block lands."""
    t0 = time.perf_counter()
    n_deltas = 0
    for d in engine.stream(reqs):
        n_deltas += 1
        if d.done:
            r = d.response
            print(f"  {r.id}[{d.stream}] += {d.tokens} [finish="
                  f"{r.finish_reason} total={len(r.tokens)}]", flush=True)
        else:
            print(f"  {d.id}[{d.stream}] += {d.tokens}", flush=True)
    dt = time.perf_counter() - t0
    s = engine.stats
    print(f"streamed {s.tokens_out} tokens across {n_deltas} deltas in "
          f"{dt:.2f} s (incl. set-up); syncs={s.syncs} "
          f"(k={args.k}: {s.tokens_out / max(s.syncs, 1):.1f} tok/sync)")
    print(f"stats: syncs={s.syncs} steps={s.steps} tokens_out={s.tokens_out} "
          f"retired={s.retired} shed={s.shed} defrags={s.defrags} "
          f"occupancy={s.occupancy:.2f}")
    print(s.summary())
    return engine


def serve_engine(cfg, args, device: torch.device, rules=None):
    # a rank of a mesh keeps its shards only
    params = serve_params(cfg, _params(cfg, device), rules)
    max_prompt = min(16, args.max_len // 2)
    engine = Engine(params, cfg, num_slots=args.batch, max_len=args.max_len,
                    k=args.k, max_prompt=max_prompt,
                    enc_len=args.max_len if cfg.family == "audio" else None,
                    page_size=args.page_size or None,
                    kv_dtype=args.kv_dtype, prefix_cache=args.prefix_cache,
                    overlap=args.overlap, device=device, rules=rules)
    reqs = _synthetic_requests(cfg, args.requests or 2 * args.batch,
                               max_prompt, args.new_tokens, args.max_len,
                               sampling=_cli_sampling(args), fanout=args.n)
    if args.stream:
        print(f"arch={cfg.name} engine=on stream=on device={device} "
              f"slots={args.batch} k={args.k} requests={len(reqs)} "
              f"temperature={args.temperature}")
        return serve_stream(cfg, engine, reqs, args)
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    responses = engine.step()            # first block: one-time set-up
    first_s = time.perf_counter() - t0
    warm_toks = engine.stats.tokens_out
    t0 = time.perf_counter()
    responses += engine.run()
    dt = time.perf_counter() - t0
    s = engine.stats
    steady_toks = s.tokens_out - warm_toks
    steady_steps = (s.syncs - 1) * args.k
    print(f"arch={cfg.name} engine=on device={device} slots={args.batch} "
          f"k={args.k} requests={len(reqs)} new_tokens={args.new_tokens}")
    print(f"first block (incl. set-up): {first_s:.2f} s")
    if steady_steps and dt > 0:
        print(f"steady-state: {steady_toks / dt:.1f} tok/s "
              f"({dt / steady_steps * 1e3:.2f} ms/step, "
              f"{dt / (s.syncs - 1) * 1e3:.2f} ms/sync at k={args.k})")
    print(f"stats: syncs={s.syncs} steps={s.steps} tokens_out={s.tokens_out} "
          f"prefill_tokens={s.prefill_tokens} retired={s.retired} "
          f"shed={s.shed} defrags={s.defrags} occupancy={s.occupancy:.2f}")
    print(s.summary())
    if engine.paged:
        print(f"paged: page_size={engine.pool.page_size} "
              f"pages={engine.pool.num_pages} "
              f"kv_dtype={engine.pool.kv_dtype} "
              f"page_bytes={engine.pool.page_bytes()} "
              f"prefix_hits={s.prefix_hits} prefix_tokens={s.prefix_tokens} "
              f"cow_copies={s.cow_copies} page_defrags={s.page_defrags}")
    for r in sorted(responses, key=lambda r: r.id)[:2]:
        print(f"  {r.id}: finish={r.finish_reason} tokens={r.tokens[:16]}")
    return responses


def serve_classic(cfg, args, device: torch.device):
    """Whole-batch greedy decode, one host round trip per token. whisper's
    cross K/V is prefilled first from seeded frame embeddings (B, max_len,
    d), as the JAX CLI does."""
    params = _params(cfg, device)
    cache = init_cache(cfg, args.batch, args.max_len, device=device,
                       enc_len=args.max_len)
    if cfg.family == "audio":
        enc = torch.randn(args.batch, args.max_len, cfg.d_model,
                          generator=torch.Generator(device=device)
                          .manual_seed(1), device=device)
        cache = prefill_audio_cache(params, cfg, cache,
                                    enc.to(torch.bfloat16))
    serve = make_serve_step(cfg)
    tok = torch.zeros(args.batch, 1, dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    tok, _, cache = serve(params, cache, tok)
    _sync(device)
    first_s = time.perf_counter() - t0
    seqs = [tok]
    steps = args.new_tokens - 1
    t0 = time.perf_counter()
    for _ in range(steps):
        tok, _, cache = serve(params, cache, tok)
        seqs.append(tok)
    _sync(device)
    dt = time.perf_counter() - t0
    out = torch.cat(seqs, dim=1).cpu()
    print(f"arch={cfg.name} engine=off device={device} batch={args.batch} "
          f"new_tokens={args.new_tokens}")
    print(f"first step (incl. set-up): {first_s:.2f} s")
    if steps and dt > 0:
        print(f"steady-state: {args.batch * steps / dt:.1f} tok/s "
              f"({dt / steps * 1e3:.2f} ms/step over {steps} timed steps)")
    for b in range(min(args.batch, 2)):
        print(f"  seq[{b}]: {out[b, :16].tolist()} ...")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--preset", choices=["tiny", "full"], default="tiny")
    ap.add_argument("--batch", type=int, default=4,
                    help="engine slots / classic batch size")
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--k", type=int, default=4,
                    help="decode steps per host sync (engine mode)")
    ap.add_argument("--requests", type=int, default=0,
                    help="synthetic request count (default 2*batch)")
    ap.add_argument("--engine", choices=["on", "off"], default="on",
                    help="off: classic per-token whole-batch loop")
    ap.add_argument("--stream", action="store_true",
                    help="engine mode: print per-request token deltas as "
                         "k-blocks land (Engine.stream)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus mass (1.0 disables)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation (0 disables)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="base seed for per-request sampling streams")
    ap.add_argument("--page-size", type=int, default=0,
                    help="engine mode: tokens per KV page (0 = whole-row "
                         "slot cache; token streams identical either way "
                         "on the CPU, and on the card at a page of 16)")
    ap.add_argument("--kv-dtype", choices=["f32", "int8"], default="f32",
                    help="engine mode, with --page-size: int8 stores the "
                         "K/V pages as int8 codes + f32 row/head scales")
    ap.add_argument("--n", type=int, default=1,
                    help="engine mode: fan each synthetic request into n "
                         "sampled streams sharing its prompt pages (stream "
                         "i seeds with fold_in_seed(seed, i))")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="engine mode, with --page-size: reuse radix-trie "
                         "shared prompt-prefix pages across requests and "
                         "skip their prefill steps")
    ap.add_argument("--overlap", action="store_true",
                    help="engine mode: double-buffer the host loop — "
                         "launch each k-block before waiting for the "
                         "previous one (tokens identical; hidden_syncs / "
                         "host_blocked stats report the effect)")
    ap.add_argument("--device", default=None,
                    help="device to run on (default cuda; raises on a host "
                         "with no card unless this says cpu)")
    add_obs_args(ap)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = smoke_config(arch) if args.preset == "tiny" else arch
    rules, joined, quiet = None, False, contextlib.nullcontext()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if args.engine != "on":
            raise ValueError("--engine off serves on one device; under "
                             "torchrun the engine serves on the mesh")
        if not dist.is_initialized():
            device = mesh.init(device.type)
            joined = True
        host = mesh.make_host_mesh(tensor_parallel=cfg.family == "dense")
        rules = make_rules(host, dist.group.WORLD)
        if dist.get_rank() == 0:
            print(f"mesh (data, model) = {host.sizes} over "
                  f"{rules.n_devices} ranks")
        else:
            quiet = contextlib.redirect_stdout(io.StringIO())
    observing = obs_begin(args)
    try:
        with quiet:
            if args.engine == "on":
                return serve_engine(cfg, args, device, rules)
            return serve_classic(cfg, args, device)
    finally:
        obs_end(args, observing)
        if joined:
            mesh.shutdown()


if __name__ == "__main__":
    main()

"""Carry the JAX package's state over to the PyTorch port, for the parity
tests of ``repro_torch``: the problem (through numpy), the index draws
(``jax.random`` gives other numbers than ``torch.Generator``, so the port
takes the JAX draws as an int64 tensor), the step size t, and the model
weights. Also :func:`spawn_gloo`, which runs a job in a CPU process group
of spawned ranks for the distributed parity tests."""
import contextlib
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from repro.core.problem import lipschitz_step
from repro.core.sampling import sample_index_batch
import repro_torch.core as tcore
from repro_torch.models import params_from_numpy
from repro_torch.configs import get_arch as t_get_arch

#: the reference's own tolerance for solver trajectories
#: (tests/test_core.py, tests/test_sstep.py)
SOLVER_ATOL = 5e-6


def to_torch(a, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype))


def to_torch_problem(problem):
    """A ``repro`` problem (Lasso, elastic net, dual SVM) -> the same
    ``repro_torch`` problem on the CPU."""
    cls = getattr(tcore, type(problem).__name__)
    fields = {f.name: getattr(problem, f.name)
              for f in dataclasses.fields(problem)}
    fields = {k: (to_torch(v, np.float32) if k in ("X", "y") else float(v))
              for k, v in fields.items()}
    return cls(**fields)


def step_size(problem, cfg) -> float:
    """The JAX package's default step t = 1/(1.05 L), as a float."""
    return float(lipschitz_step(problem.X, cfg.power_iters))


def to_torch_config(cfg) -> tcore.SolverConfig:
    """``repro`` SolverConfig -> ``repro_torch`` SolverConfig, field by
    field."""
    return tcore.SolverConfig(**dataclasses.asdict(cfg))


def jax_draws(key, cfg, problem, schedule="gram") -> torch.Tensor:
    """The (T, m) draws the JAX s-step core takes from ``key``, as int64:
    over the problem's units (``gram``), or over its coordinates without
    replacement (``coord``, BCD)."""
    if schedule == "coord":
        units, wr = problem.dim, False
    else:
        units, wr = problem.n_units, cfg.with_replacement
    m = max(int(cfg.b * units), 1)
    return to_torch(sample_index_batch(key, cfg.T, units, m, wr), np.int64)


def to_torch_config_arch(cfg):
    """``repro`` ArchConfig -> the port's ArchConfig, field by field."""
    return t_get_arch(cfg.name).scaled(**dataclasses.asdict(cfg))


def to_torch_params(jax_params, cfg, dtype=torch.bfloat16):
    """``repro.models.init_params`` weights -> the port's parameter dict on
    the CPU (bf16 by default: every use in JAX casts to bf16 first)."""
    return params_from_numpy(to_torch_config_arch(cfg),
                             jax.tree.map(np.asarray, jax_params),
                             device="cpu", dtype=dtype)


SRC = Path(__file__).resolve().parents[1] / "src"

#: one spawned rank: joins a gloo group of ``world`` through a FileStore in
#: the job's directory, runs ``main(rank, world, payload)`` from job.py and
#: saves its result. It imports torch and repro_torch only.
_RANK = r"""
import sys
import torch
import torch.distributed as dist
from repro_torch.launch import mesh
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
mesh.init("cpu", rank=rank, world_size=world,
          store=dist.FileStore(tmp + "/store", world))
try:
    scope = {}
    exec(open(tmp + "/job.py").read(), scope)
    result = scope["main"](rank, world, torch.load(tmp + "/payload.pt"))
    torch.save(result, f"{tmp}/result{rank}.pt")
finally:
    mesh.shutdown()
"""


def spawn_gloo(world: int, job: str, payload, tmp, timeout: float = 120.0):
    """Run ``job`` (Python source defining ``main(rank, world, payload)``)
    in ``world`` spawned CPU ranks of one gloo process group, which meet
    through a FileStore under ``tmp`` (no network). ``payload`` goes to
    every rank through ``torch.save``. Returns each rank's result, in rank
    order; raises with a rank's stderr if one fails, and kills them all if
    one outlives ``timeout``."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "job.py").write_text(job)
    torch.save(payload, tmp / "payload.pt")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r),
                               str(world), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, err) in enumerate(zip(procs, errs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {world} failed:\n{err[-4000:]}")
    return [torch.load(tmp / f"result{r}.pt") for r in range(world)]


_JAX_STEPS: dict = {}


def _to_jax(t):
    import jax.numpy as jnp
    if isinstance(t, dict):
        return {k: _to_jax(v) for k, v in t.items()}
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _to_torch(a, like):
    if isinstance(like, dict):
        return {k: _to_torch(a[k], v) for k, v in like.items()}
    x = torch.from_numpy(np.asarray(a.astype(np.float32) if str(a.dtype) ==
                                    "bfloat16" else a).copy())
    return x.to(like.dtype)


def jax_model_serve_step(cfg, jax_params):
    """A serve step for the port's engine that runs the JAX package's model
    (``repro.launch.steps.make_serve_step`` under the ``xla`` backend) on
    the port's cache, converting the cache both ways (bf16 exactly through
    float32). With it the port's engine and the JAX engine see the same
    logits at every step, so their streams must be bit-identical: the
    engine's machinery (admission, pools, paging, the prefix cache,
    fan-out, sampling keys, overlap) is held to JAX's without the model's
    float32 rounding differences in the way."""
    from repro.kernels import registry as jregistry
    from repro.launch.steps import make_serve_step as j_make_serve_step
    key = (cfg, id(jax_params))
    if key not in _JAX_STEPS:           # one jit (and its compiles) an arch
        with jregistry.use("xla"):
            _JAX_STEPS[key] = jax.jit(j_make_serve_step(cfg, None))
    step = _JAX_STEPS[key]

    def serve(params, cache, tokens, positions=None, page_table=None):
        args = [_to_jax(cache), _to_jax(tokens),
                None if positions is None else _to_jax(positions),
                None if page_table is None else _to_jax(page_table)]
        with jregistry.use("xla"):
            nxt, logits, new = step(jax_params, *args)
        return (_to_torch(nxt, tokens), _to_torch(logits, torch.empty(
            (), dtype=torch.bfloat16)), _to_torch(new, cache))

    return serve


def jax_audio_prefill(cfg, jax_params):
    """``prefill_audio_cache`` for the port's engine by the JAX package's
    (whisper's cross K/V at admission), converting both ways."""
    from repro.models.transformer import prefill_audio_cache as j_prefill
    key = ("prefill", cfg, id(jax_params))
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = jax.jit(lambda p, c, e: j_prefill(p, cfg, c, e))
    fn = _JAX_STEPS[key]

    def prefill(params, tcfg, cache, enc_embeds):
        new = fn(jax_params, _to_jax(cache), _to_jax(enc_embeds))
        return _to_torch(new, cache)

    return prefill


@contextlib.contextmanager
def jax_model_in_port_engine(cfg, jax_params):
    """Inside the context the port's engines built run the JAX package's
    model (:func:`jax_model_serve_step`, :func:`jax_audio_prefill`); the
    rest of each engine is the port's."""
    import repro_torch.serve.decode as tdecode
    import repro_torch.serve.engine as tengine
    saved = tdecode.make_serve_step, tengine.prefill_audio_cache
    tdecode.make_serve_step = lambda tcfg: jax_model_serve_step(cfg,
                                                                jax_params)
    tengine.prefill_audio_cache = jax_audio_prefill(cfg, jax_params)
    try:
        yield
    finally:
        tdecode.make_serve_step, tengine.prefill_audio_cache = saved


#: the archs of the JAX serve suite's family sweeps (tests/test_paged.py,
#: tests/test_overlap.py): one a family
FAMILY_ARCHS = ["internlm2-1.8b", "granite-moe-1b-a400m", "mamba2-780m",
                "zamba2-2.7b", "whisper-medium", "qwen2-vl-2b"]
#: and deepseek's dense first layer, where a sweep is cheap
ALL_FAMILY_ARCHS = FAMILY_ARCHS + ["deepseek-moe-16b"]
#: the JAX suite's requests (tests/test_paged.py): ragged prompts, 6 new
SERVE_PROMPTS = [[7], [3, 11, 5], [9, 2], [4, 4, 4, 8], [13]]


@functools.lru_cache(maxsize=None)
def family_setup(name):
    """(JAX smoke config, port config, JAX params, port params) of an arch:
    the JAX package's ``init_params(PRNGKey(0))`` carried over."""
    from repro.configs import get_arch as j_get_arch, smoke_config
    from repro.models import init_params as j_init_params
    cfg = smoke_config(j_get_arch(name))
    jp = j_init_params(cfg, jax.random.PRNGKey(0))
    return cfg, to_torch_config_arch(cfg), jp, to_torch_params(jp, cfg)


def serve_requests(cls, sampling_cls, cfg, sampled=False, prompts=None,
                   max_new=6, n=1, sp=None):
    """The JAX suite's request set for ``cls`` (either package's
    ``Request``): whisper's frames seeded as there, request i sampled with
    seed i at T 0.8, top-p 0.9, top-k 8 (or ``sp``'s policy)."""
    rng = np.random.RandomState(0)
    reqs = []
    for i, p in enumerate(prompts or SERVE_PROMPTS):
        enc = rng.randn(16, cfg.d_model).astype(np.float32) \
            if cfg.family == "audio" else None
        pol = None
        if sampled:
            pol = sampling_cls(temperature=0.8, top_p=0.9, top_k=8, seed=i) \
                if sp is None else sampling_cls(**dict(sp, seed=i))
        reqs.append(cls(id=f"r{i}", prompt=p, max_new_tokens=max_new,
                        enc_embeds=enc, sampling=pol, n=n))
    return reqs


def engine_kw(cfg, **kw):
    """The JAX serve suite's engine shape (tests/test_paged.py): 3 slots,
    max_len 32, prompts up to 8, whisper's 16 frames."""
    return dict(num_slots=3, max_len=32, max_prompt=8,
                enc_len=16 if cfg.family == "audio" else None, **kw)


@functools.lru_cache(maxsize=None)
def jax_engine_streams(name, sampled, **kw):
    """The JAX engine's streams (XLA route, k=4: its streams do not depend
    on k, tests/test_paged.py) over :func:`serve_requests`."""
    from repro.kernels import registry as jregistry
    from repro.serve import (Engine as JEngine, Request as JRequest,
                             SamplingParams as JSampling)
    cfg, _, jp, _ = family_setup(name)
    with jregistry.use("xla"):
        eng = JEngine(jp, cfg, k=4, **engine_kw(cfg, **kw))
        out = eng.run(serve_requests(JRequest, JSampling, cfg, sampled))
    return {r.id: list(r.tokens) for r in out}


def port_engine_streams(name, sampled, *, k=4, jax_model=False,
                        audit=False, **kw):
    """The port's engine over :func:`serve_requests` on the CPU, running
    the JAX package's model with ``jax_model`` (built inside
    :func:`jax_model_in_port_engine`: the block takes its serve step at
    construction), drained under the port's sync audit with ``audit``.
    Returns (streams, engine, audit or None)."""
    from repro_torch import obs
    from repro_torch.serve import Engine, Request, SamplingParams
    cfg, tcfg, jp, tp = family_setup(name)
    reqs = serve_requests(Request, SamplingParams, tcfg, sampled)
    with (jax_model_in_port_engine(cfg, jp) if jax_model
          else contextlib.nullcontext()):
        eng = Engine(tp, tcfg, k=k, device="cpu", **engine_kw(cfg, **kw))
        with (obs.sync_audit("cpu") if audit
              else contextlib.nullcontext()) as a:
            out = eng.run(reqs)
    return {r.id: list(r.tokens) for r in out}, eng, a

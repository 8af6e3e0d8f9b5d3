"""Carry the JAX package's state over to the PyTorch port, for the parity
tests of ``repro_torch``: the problem (through numpy), the index draws
(``jax.random`` gives other numbers than ``torch.Generator``, so the port
takes the JAX draws as an int64 tensor), the step size t, and the model
weights. Also :func:`spawn_gloo`, which runs a job in a CPU process group
of spawned ranks for the distributed parity tests."""
import dataclasses
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

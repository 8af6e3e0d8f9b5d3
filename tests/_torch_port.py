"""Carry the JAX package's state over to the PyTorch port, for the parity
tests of ``repro_torch``: the problem (through numpy), the index draws
(``jax.random`` gives other numbers than ``torch.Generator``, so the port
takes the JAX draws as an int64 tensor), the step size t, and the model
weights."""
import dataclasses

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


def to_torch_problem(problem) -> tcore.LassoProblem:
    """``repro`` LassoProblem -> ``repro_torch`` LassoProblem on the CPU."""
    return tcore.LassoProblem(X=to_torch(problem.X, np.float32),
                              y=to_torch(problem.y, np.float32),
                              lam=float(problem.lam))


def step_size(problem, cfg) -> float:
    """The JAX package's default step t = 1/(1.05 L), as a float."""
    return float(lipschitz_step(problem.X, cfg.power_iters))


def to_torch_config(cfg) -> tcore.SolverConfig:
    """``repro`` SolverConfig -> ``repro_torch`` SolverConfig, field by
    field."""
    return tcore.SolverConfig(**dataclasses.asdict(cfg))


def jax_draws(key, cfg, problem) -> torch.Tensor:
    """The (T, m) draws the JAX s-step core takes from ``key``, as int64."""
    m = max(int(cfg.b * problem.n_units), 1)
    idx = sample_index_batch(key, cfg.T, problem.n_units, m,
                             cfg.with_replacement)
    return to_torch(idx, np.int64)


def to_torch_config_arch(cfg):
    """``repro`` ArchConfig -> the port's ArchConfig, field by field."""
    return t_get_arch(cfg.name).scaled(**dataclasses.asdict(cfg))


def to_torch_params(jax_params, cfg, dtype=torch.bfloat16):
    """``repro.models.init_params`` weights -> the port's parameter dict on
    the CPU (bf16 by default: every use in JAX casts to bf16 first)."""
    return params_from_numpy(to_torch_config_arch(cfg),
                             jax.tree.map(np.asarray, jax_params),
                             device="cpu", dtype=dtype)

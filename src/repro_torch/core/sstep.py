"""The s-step solver core (paper Algorithms I-IV, one schedule).

Every solver of the port — classical and communication-avoiding — is one
instantiation of the same skeleton:

  1. draw T index sets up front (``sample_index_batch``), or take them
     from the caller (``idx``, shape (T, m));
  2. regroup them into T/k blocks of k (classical solvers are the k=1
     instantiation of the same code path);
  3. per outer block, compute the block's k sampled Gram pairs at once
     (``problem.block_stats``: one ``gram_gather`` dispatch, which reads
     the sampled rows where they lie);
  4. run the k per-iteration updates of the rule over the block with no
     further communication: one dispatch of the rule's block op, a whole
     k-block of updates in one kernel launch (the JAX package's
     ``lax.scan``; ``update_rules``).

Only the ``gram`` schedule is ported; BCD's coordinate schedule comes with
BCD. The step size and the prox scalars are built once per solve as device
tensors, and the iteration counter lives on the host, so the loop reads
nothing back from the device: a solve makes T/k block dispatches (T for
the classical schedule) and no other update op.

``host_loop=True`` waits for the device once per block
(``torch.cuda.synchronize()`` on a CUDA problem) and counts the blocks in
``syncs.blocks``: T/k for the CA schedule, T for the classical one — the
paper's latency claim, counted at the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch.core import update_rules as ur
from repro_torch.core.problem import SolverConfig
from repro_torch.core.sampling import sample_index_batch
from repro_torch.kernels.prox_step.ops import prox_scalars


@dataclasses.dataclass(frozen=True)
class UpdateRule:
    """One solver's per-iteration rule, plugged into the shared schedule."""
    name: str
    init: Callable                        # (problem, cfg, w0) -> state
    #: (problem, cfg, scal, (G, R) of a k-block, state) -> (state, W (k, dim))
    block: Callable
    extract: Callable                     # state -> w


@dataclasses.dataclass
class HostSyncs:
    """Host waits of a ``host_loop`` solve: one per outer block."""
    blocks: int = 0


def validate_schedule(cfg: SolverConfig, solver: str) -> None:
    """The shared T/k check, naming the solver: CA solvers regroup the T
    draws into T/k blocks of k, so T % k must be 0. ``SolverConfig``
    already enforces this at construction; this re-check catches configs
    mutated past it."""
    if cfg.k < 1:
        raise ValueError(f"{solver}: cfg.k must be >= 1, got k={cfg.k}")
    if cfg.T % cfg.k != 0:
        raise ValueError(
            f"{solver}: cfg.T must be divisible by cfg.k (the k-step "
            f"schedule runs T/k outer iterations of k updates each), got "
            f"T={cfg.T}, k={cfg.k}. Pick T a multiple of k or k=1.")


def _resolve_step(problem, cfg: SolverConfig) -> torch.Tensor:
    if cfg.step_size is not None:
        return torch.tensor(cfg.step_size, dtype=problem.X.dtype,
                            device=problem.device)
    return problem.default_step(cfg)


def draw_size(problem, cfg: SolverConfig) -> int:
    """m = floor(b * units), at least 1: columns drawn per iteration."""
    return max(int(cfg.b * problem.n_units), 1)


def _as_generator(gen, device) -> torch.Generator:
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator(device=device).manual_seed(int(gen))


def _draws(problem, cfg: SolverConfig, gen, idx) -> torch.Tensor:
    m = draw_size(problem, cfg)
    if idx is None:
        if gen is None:
            raise ValueError("solve needs a generator (or seed) or idx")
        return sample_index_batch(_as_generator(gen, problem.device), cfg.T,
                                  problem.n_units, m, cfg.with_replacement)
    if tuple(idx.shape) != (cfg.T, m):
        raise ValueError(f"idx must have shape (T, m) = {(cfg.T, m)}, got "
                         f"{tuple(idx.shape)}")
    return idx.to(device=problem.device, dtype=torch.int64)


def solve(problem, cfg: SolverConfig,
          gen: Union[torch.Generator, int, None], rule: UpdateRule, *,
          name: str, ca: bool = False, idx: Optional[torch.Tensor] = None,
          w0: Optional[torch.Tensor] = None, collect_history: bool = False,
          host_loop: bool = False, syncs: Optional[HostSyncs] = None):
    """Run ``rule`` under the s-step schedule.

    ``ca=False`` is the classical solver: block size 1, one Gram batch per
    iteration. ``ca=True`` regroups into T/k blocks of cfg.k. The draws come
    from ``idx`` (T, m) when given, else from ``gen`` (a ``torch.Generator``
    on the problem's device, or an int seed). Returns w_T, or
    (w_T, (T, dim) iterate history) when ``collect_history``.

    ``host_loop=True`` waits for the device after every block and counts the
    waits in ``syncs`` (no history support), as the JAX package's host loop
    does for its sync audit.
    """
    if ca:
        validate_schedule(cfg, name)
    if host_loop and collect_history:
        raise ValueError(f"{name}: host_loop does not support "
                         "collect_history")
    block = cfg.k if ca else 1
    t = _resolve_step(problem, cfg)
    variant, lam, mu, lo, hi = problem.prox_params()
    scal = prox_scalars(t, lam, mu, lo, hi)
    draws = _draws(problem, cfg, gen, idx)
    draws = draws.reshape(cfg.T // block, block, draws.shape[1])
    if w0 is None:
        w0 = torch.zeros(problem.dim, dtype=problem.X.dtype,
                         device=problem.device)
    state = rule.init(problem, cfg, w0)
    hist = []
    for idx_block in draws:
        state, W = rule.block(problem, cfg, scal,
                              problem.block_stats(idx_block), state)
        if collect_history:
            hist.append(W)
        if host_loop:
            if problem.device.type == "cuda":
                torch.cuda.synchronize(problem.device)
            if syncs is not None:
                syncs.blocks += 1
    w = rule.extract(state)
    if collect_history:
        return w, torch.cat(hist)
    return w


# ------------------------------------------------------------------------
# the ported update rules
# ------------------------------------------------------------------------

def _fista_init(problem, cfg, w0):
    return ur.init_state(w0)


def _fista_block(problem, cfg, scal, stats, state):
    return ur.fista_block(stats[0], stats[1], state, scal,
                          variant=problem.prox_params()[0])


def _pnm_block(problem, cfg, scal, stats, state):
    return ur.pnm_block(stats[0], stats[1], state, scal, cfg.Q,
                        variant=problem.prox_params()[0])


def _iter_w(state):
    return state.w


FISTA_RULE = UpdateRule("fista", _fista_init, _fista_block, _iter_w)
PNM_RULE = UpdateRule("pnm", _fista_init, _pnm_block, _iter_w)

RULES = {r.name: r for r in (FISTA_RULE, PNM_RULE)}

"""The s-step solver core (paper Algorithms I-IV, one schedule).

Every solver of the port — classical and communication-avoiding — is one
instantiation of the same skeleton:

  1. draw T index sets up front (``sample_index_batch``), or take them
     from the caller (``idx``, shape (T, m));
  2. regroup them into T/k blocks of k (classical solvers are the k=1
     instantiation of the same code path);
  3. per outer block, compute the block's statistics at once: the ONE
     collective of the distributed form (:mod:`repro_torch.core.distributed`
     all-reduces them there, and nothing else);
  4. run the k per-iteration updates of the rule over the block with no
     further communication.

Two schedules:

* ``gram`` — the update consumes (G_j, R_j) sampled-Gram statistics; a
  block's k pairs come from one ``problem.block_stats`` (one ``gram_gather``
  dispatch, which reads the sampled rows where they lie), and its k updates
  from one dispatch of the rule's block op, a whole k-block of updates in
  one kernel launch (the JAX package's ``lax.scan``; ``update_rules``).
  Rules: ``FISTA_RULE``, ``PNM_RULE``, ``PDHG_RULE``.
* ``coord`` — block coordinate descent (``BCD_RULE``): per outer block the
  statistics are the stacked cross-Gram C = inv_rho * B[U] B[U]^T over the
  k coordinate draws (the ``gram`` op on B[U], gathered by
  ``index_select`` as the JAX package gathers it outside its kernel) and
  the block gradient g0; the inner k steps replay each iteration's
  gradient as g0_j + C_j @ delta (delta: the coordinate updates applied so
  far inside the block), which is algebraically the running-residual
  gradient. They are plain tensor code, as in the JAX package (no kernel).
  At k=1 the correction is exactly zero, so the classical solver is again
  the k=1 instantiation.

The step size and the prox scalars are built once per solve as device
tensors, and the iteration counter lives on the host, so the loop reads
nothing back from the device: a gram-schedule solve makes T/k block
dispatches (T for the classical schedule) and no other update op.

``host_loop=True`` brackets every block with
:func:`repro_torch.obs.mark_dispatch` and a counted wait for the device
(``obs.sync_audit.block_until_ready``: ``torch.cuda.synchronize()`` on a
card), and counts the blocks in ``syncs.blocks``, so an enclosing
:func:`repro_torch.obs.sync_audit` measures the paper's latency claim at the
torch boundary: T/k round-trip epochs for the CA schedule, T for the
classical one, equal to ``syncs.blocks``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch import obs, to_device
from repro_torch.core import update_rules as ur
from repro_torch.core.problem import SolverConfig
from repro_torch.core.sampling import sample_index_batch
from repro_torch.core.soft_threshold import prox_elem
from repro_torch.kernels import registry
from repro_torch.kernels.prox_step.ops import prox_scalars
from repro_torch.obs.sync_audit import block_until_ready


def _scal(problem, cfg, scal):
    return scal


@dataclasses.dataclass(frozen=True)
class UpdateRule:
    """One solver's per-iteration rule, plugged into the shared schedule.
    ``schedule`` picks the skeleton: ``"gram"`` rules take the (G, R) of a
    k-block; ``"coord"`` marks the block-coordinate skeleton, whose inner
    update is fixed (the problem enters through ``coord_view()`` and
    ``prox_params()``)."""
    name: str
    schedule: str                         # "gram" | "coord"
    init: Optional[Callable] = None       # (problem, cfg, w0) -> state
    #: (problem, cfg, params, (G, R) of a k-block, state)
    #:     -> (state, W (k, dim))
    block: Optional[Callable] = None
    extract: Optional[Callable] = None    # state -> w
    #: (problem, cfg, scal) -> the params ``block`` takes, built once a solve
    params: Callable = _scal


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
        return to_device(torch.tensor(cfg.step_size, dtype=problem.X.dtype),
                         problem.device)
    return problem.default_step(cfg)


def draw_size(problem, cfg: SolverConfig, schedule: str = "gram") -> int:
    """m = floor(b * units), at least 1: units drawn per iteration, the
    problem's sampleable units (``gram``) or its coordinates (``coord``)."""
    units = problem.dim if schedule == "coord" else problem.n_units
    return max(int(cfg.b * units), 1)


def _as_generator(gen, device) -> torch.Generator:
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator(device=device).manual_seed(int(gen))


def draws(problem, cfg: SolverConfig, gen, idx,
          schedule: str = "gram") -> torch.Tensor:
    """The (T, m) draws of a solve: ``idx`` checked, or drawn from ``gen``
    (a ``torch.Generator`` on the problem's device, or an int seed) over
    the schedule's units. Coordinate blocks are drawn without replacement
    whatever ``cfg.with_replacement`` says: a coordinate repeated inside
    one draw would double-apply its update."""
    m = draw_size(problem, cfg, schedule)
    if idx is None:
        if gen is None:
            raise ValueError("solve needs a generator (or seed) or idx")
        coord = schedule == "coord"
        return sample_index_batch(_as_generator(gen, problem.device), cfg.T,
                                  problem.dim if coord else problem.n_units,
                                  m, False if coord else cfg.with_replacement)
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

    ``ca=False`` is the classical solver: block size 1, one batch of
    statistics per iteration. ``ca=True`` regroups into T/k blocks of cfg.k.
    The draws come from ``idx`` (T, m) when given, else from ``gen`` (a
    ``torch.Generator`` on the problem's device, or an int seed). Returns
    w_T, or (w_T, (T, dim) iterate history) when ``collect_history``.

    ``host_loop=True`` marks a dispatch before every block, waits for the
    device after it (a read the sync audit counts) and counts the waits in
    ``syncs`` (no history support), as the JAX package's host loop does.
    """
    if ca:
        validate_schedule(cfg, name)
    if host_loop and collect_history:
        raise ValueError(f"{name}: host_loop does not support "
                         "collect_history")
    idx = draws(problem, cfg, gen, idx, rule.schedule)
    return run(problem, cfg, rule, idx, cfg.k if ca else 1,
               _resolve_step(problem, cfg), w0,
               collect_history=collect_history, host_loop=host_loop,
               syncs=syncs)


def run(problem, cfg: SolverConfig, rule: UpdateRule, idx: torch.Tensor,
        block: int, t: torch.Tensor, w0: Optional[torch.Tensor] = None, *,
        reduce: Optional[Callable] = None, m_norm=None, inv_rho=None,
        collect_history: bool = False, host_loop: bool = False,
        syncs: Optional[HostSyncs] = None):
    """The loop behind :func:`solve`, on the draws ``idx`` (T, m) in blocks
    of ``block`` with the step ``t`` (a device scalar tensor).

    The distributed solvers run it on a rank's shard: ``reduce(buf)``
    all-reduces, in place, the one flat buffer holding a block's statistics
    (the k (G, R) pairs, or C and g0); ``m_norm`` (gram) and ``inv_rho``
    (coord) are the global normalizations."""
    variant, lam, mu, lo, hi = problem.prox_params()
    if w0 is None:
        w0 = torch.zeros(problem.dim, dtype=problem.X.dtype,
                         device=problem.device)
    blocks = idx.reshape(cfg.T // block, block, idx.shape[1])
    if rule.schedule == "coord":
        view = problem.coord_view()
        if inv_rho is not None:
            view = view._replace(inv_rho=inv_rho)
        state = (w0.clone(), view.B.T @ w0 - view.offset)

        def step(state, idx_block):
            return _coord_block(view, t, problem.prox_params(), state,
                                idx_block, collect_history, reduce)
        extract = _first
    else:
        params = rule.params(problem, cfg, prox_scalars(t, lam, mu, lo, hi))
        state = rule.init(problem, cfg, w0)

        def step(state, idx_block):
            stats = _gram_stats(problem, idx_block, reduce, m_norm)
            return rule.block(problem, cfg, params, stats, state)
        extract = rule.extract
    hist = []
    for idx_block in blocks:
        if host_loop:
            obs.mark_dispatch(f"sstep.{rule.name}")
        state, W = step(state, idx_block)
        if collect_history:
            hist.append(W)
        if host_loop:
            block_until_ready(problem.device)
            if syncs is not None:
                syncs.blocks += 1
    w = extract(state)
    if collect_history:
        return w, torch.cat(hist)
    return w


def _first(state):
    return state[0]


# ------------------------------------------------------------------------
# per-block bodies
# ------------------------------------------------------------------------

def _gram_stats(problem, idx_block, reduce, m_norm):
    """The k (G, R) pairs of a block; with ``reduce``, written into one
    flat buffer and all-reduced there, in one collective."""
    if reduce is None:
        return problem.block_stats(idx_block)
    k, d = idx_block.shape[0], problem.d
    buf = torch.empty(k * (d * d + d), dtype=torch.float32,
                      device=problem.device)
    stats = problem.block_stats(idx_block, m_norm=m_norm, out=buf)
    reduce(buf)
    return stats


def _coord_block(view, t, prox, state, idx_block, collect_history, reduce):
    """One outer iteration of the coordinate schedule (CA-BCD, 1612.04003).

    The stacked cross-Gram C and block gradient g0, in one flat buffer, are
    the one collective (``reduce``); the inner steps replay the k
    coordinate updates exactly, correcting each step's gradient by C @
    delta for the updates already applied inside the block. At a block of
    one, delta is identically zero and this is plain BCD arithmetic. w (the
    solve's own copy) is updated in place. Returns ((w, v), the iterate
    after each step when ``collect_history``)."""
    w, v = state
    variant, lam, mu, lo, hi = prox
    blk, m_c = idx_block.shape
    U = idx_block.reshape(-1)                   # (blk * m_c,)
    bm = U.numel()
    BU = view.B.index_select(0, U)              # (bm, n_aux)
    buf = torch.empty(bm * bm + bm, dtype=w.dtype, device=w.device)
    C, g0 = buf[:bm * bm].view(bm, bm), buf[bm * bm:]
    torch.mul(registry.dispatch("gram", BU), view.inv_rho, out=C)
    torch.mul(BU @ v - view.lin.index_select(0, U), view.inv_rho, out=g0)
    if reduce is not None:
        reduce(buf)
    delta = torch.zeros(bm, dtype=w.dtype, device=w.device)
    hist = []
    for jj in range(blk):
        s = slice(jj * m_c, (jj + 1) * m_c)
        Uj = U[s]
        grad = g0[s] + C[s] @ delta             # exact replay of the
        wU = w.index_select(0, Uj)              # running-residual gradient
        wU_new = prox_elem(wU - t * grad, t, variant=variant, lam=lam,
                           mu=mu, lo=lo, hi=hi)
        w.index_copy_(0, Uj, wU_new)
        delta[s] = wU_new - wU
        if collect_history:
            hist.append(w.clone())
    v = v + BU.T @ delta                        # residual roll-forward
    return (w, v), (torch.stack(hist) if collect_history else None)


# ------------------------------------------------------------------------
# the update rules
# ------------------------------------------------------------------------

def _fista_init(problem, cfg, w0):
    return ur.init_state(w0)


def _fista_block(problem, cfg, scal, stats, state):
    return ur.fista_block(stats[0], stats[1], state, scal,
                          variant=problem.prox_params()[0])


def _pnm_block(problem, cfg, scal, stats, state):
    return ur.pnm_block(stats[0], stats[1], state, scal, cfg.Q,
                        variant=problem.prox_params()[0])


def _pdhg_init(problem, cfg, w0):
    return ur.init_pdhg_state(w0)


def _pdhg_params(problem, cfg, scal):
    """scal, and PDHG's dual step sigma as a (1,) device tensor: cfg.sigma,
    or 0.5 / t computed on the device (``update_rules.pdhg_sigma``)."""
    return scal, ur.pdhg_sigma(cfg.sigma, scal[0])


def _pdhg_block(problem, cfg, params, stats, state):
    scal, sigma = params
    return ur.pdhg_block(stats[0], stats[1], state, scal, sigma,
                         variant=problem.prox_params()[0])


def _iter_w(state):
    return state.w


FISTA_RULE = UpdateRule("fista", "gram", _fista_init, _fista_block, _iter_w)
PNM_RULE = UpdateRule("pnm", "gram", _fista_init, _pnm_block, _iter_w)
PDHG_RULE = UpdateRule("pdhg", "gram", _pdhg_init, _pdhg_block, _iter_w,
                       _pdhg_params)
BCD_RULE = UpdateRule("bcd", "coord")

RULES = {r.name: r for r in (FISTA_RULE, PNM_RULE, PDHG_RULE, BCD_RULE)}

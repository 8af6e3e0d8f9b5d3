"""The paper's communication schedule lifted to LM training, on
``torch.distributed`` (the counterpart of ``repro.optim.ca_sync``).

Three mechanisms:

1. **CA gradient accumulation (exact)**: the train step
   (``launch.steps.make_train_step``) accumulates ``ca_k`` microbatch
   gradients and reduces them in one ``all_reduce`` a step, where naive DDP
   reduces every microbatch. Gradients are linear in the batch, so the
   result is the classical schedule's, with k times fewer collectives.

2. **CA local-SGD (k-AVG family, approximate)**: :func:`ca_local_sgd_solver`
   runs k SGD steps on each rank's slice with no communication and
   averages the parameters once every k steps. Unlike (1) this changes the
   trajectory (the paper's exact unrolling holds for Gram-linear
   iterations only).

3. **Stale-k aggregation (synchronization-avoiding)**:
   :func:`ca_stale_k_solver` (Devarakonda et al., arXiv:1712.06047): round t
   lands the aggregate round t-1 launched, runs its k local steps and
   launches its own with ``all_reduce(async_op=True)``; the handle is waited
   only at the next round's entry (or in ``finalize``), so no rank blocks on
   the collective inside its round. The staleness is exactly one round,
   and ``damping`` scales the stale aggregate on arrival (step-size
   damping, gamma ~ 1/(1 + staleness)).

Both solvers take ``loss_fn(params, batch) -> scalar``, a parameter tree of
one floating dtype, and batches whose leaves are (k, B, ...) with B the
global rows of each local step: rank r of P takes rows [r B/P, (r+1) B/P).
Each round makes one collective of one flat buffer (the parameters or the
delta, and the loss), counted in ``counter`` (``core.distributed
.CollectiveCount``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core.distributed import CollectiveCount
from repro_torch.tree import leaves, tree_map


def _rebuild(tree, flat: torch.Tensor):
    """``tree``'s structure over consecutive views of ``flat``, in the
    order of ``leaves(tree)`` (dict keys sorted)."""
    off = 0

    def walk(sub):
        nonlocal off
        if isinstance(sub, dict):
            return {k: walk(sub[k]) for k in sorted(sub)}
        if isinstance(sub, (list, tuple)):
            subs = [walk(v) for v in sub]
            return type(sub)(*subs) if hasattr(sub, "_fields") else \
                type(sub)(subs)
        v = flat[off:off + sub.numel()].view(sub.shape)
        off += sub.numel()
        return v
    return walk(tree)


def _pack(tree) -> torch.Tensor:
    """A fresh flat copy of the tree's leaves with one more slot (the
    loss), in their common dtype."""
    ls = leaves(tree)
    dtypes = {t.dtype for t in ls}
    if len(dtypes) != 1:
        raise ValueError(f"ca_sync: the parameters must share one dtype, "
                         f"got {sorted(map(str, dtypes))}")
    return torch.cat([t.detach().reshape(-1) for t in ls]
                     + [ls[0].new_zeros(1)])


def _local_rows(batches, group):
    """This rank's rows (dim 1) of every batch leaf."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)

    def rows(t):
        B = t.shape[1]
        if B % world:
            raise ValueError(f"ca_sync: {B} rows a step do not split over "
                             f"{world} ranks")
        n = B // world
        return t[:, rank * n:(rank + 1) * n]
    return tree_map(rows, batches), world


def _local_steps(loss_fn, params, batches, k: int, lr: float):
    """k SGD steps on ``params`` (views of a flat buffer, updated in
    place); returns the mean of the k losses, a device scalar."""
    losses = []
    for i in range(k):
        batch = tree_map(lambda t: t[i], batches)
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = loss_fn(p, batch)
        grads = torch.autograd.grad(loss, leaves(p))
        with torch.no_grad():
            for t, g in zip(leaves(params), grads):
                t.sub_(lr * g)
        losses.append(loss.detach())
        del p, grads
    return torch.stack(losses).mean()


def _reduce(buf, group, counter, async_op=False):
    # THE collective: one all-reduce of one flat buffer a round
    work = dist.all_reduce(buf, group=group, async_op=async_op)
    if counter is not None:
        counter.all_reduces += 1
        counter.words += buf.numel()
    return work


def ca_local_sgd_solver(loss_fn: Callable, group=None, *, k: int, lr: float,
                        counter: Optional[CollectiveCount] = None):
    """Build step(params, batches) -> (params, mean_loss).

    Each rank runs k SGD steps on its slice of ``batches`` (leaves (k, B,
    ...)), then the parameters and the mean local loss are averaged over
    the group in one ``all_reduce``: one collective per k steps. The
    returned parameters are views of one fresh flat buffer; ``mean_loss``
    a device scalar.
    """
    def step(params, batches):
        local, world = _local_rows(batches, group)
        flat = _pack(params)
        moved = _rebuild(params, flat)
        flat[-1] = _local_steps(loss_fn, moved, local, k, lr)
        _reduce(flat, group, counter)
        flat.div_(world)
        return moved, flat[-1]
    return step


class StaleKCarry(NamedTuple):
    """A stale-k round's carry: the landed ``params``, the ``inflight``
    flat buffer (the round's summed delta and loss, valid once ``work``
    completes), the collective's ``work`` handle (None before the first
    round), ``loss``, the round's mean loss, filled when the aggregate
    lands, and ``launched``, the index of the round that launched it."""
    params: Any
    inflight: Optional[torch.Tensor]
    work: Any
    loss: Optional[torch.Tensor]
    launched: int


class StaleKSolver(NamedTuple):
    """``ca_stale_k_solver`` handle: ``carry = init(params)``, then
    ``carry, loss = step(carry, batches)`` per round, and
    ``params = finalize(carry)`` to land the last in-flight aggregate.
    ``waits`` logs (round launched, round waited) for every collective
    waited: the second is always later than the first."""
    init: Callable
    step: Callable
    finalize: Callable
    waits: list


def ca_stale_k_solver(loss_fn: Callable, group=None, *, k: int, lr: float,
                      damping: float = 1.0,
                      counter: Optional[CollectiveCount] = None
                      ) -> StaleKSolver:
    """Stale-k asynchronous aggregation: local-SGD whose collective result
    is consumed one round late (arXiv:1712.06047).

    Each round first lands the previous round's aggregate (``params +
    damping * (summed delta / P)``), then runs k local SGD steps on the
    rank's slice with no communication, and launches the next aggregate
    (the delta ``moved - params`` and the mean local loss, summed by
    ``all_reduce(async_op=True)``). Its handle is waited at the next round's
    entry or in ``finalize``, never inside its own round. The staleness
    bound is exactly one round: round t's gradients see collectives through
    round t-1 and nothing older.

    With ``damping=1.0`` this one-round pipeline reproduces synchronous
    :func:`ca_local_sgd_solver`: round t starts from the point the
    synchronous solver reaches after t averages, so per-round losses match
    to float tolerance and ``finalize`` after T rounds equals the
    synchronous parameters after T averages. Damping < 1 trades that
    equivalence for robustness when real asynchrony reorders arrivals.

    ``step`` returns the round's mean loss as a device scalar that the
    round's aggregate fills when it lands (the next ``step`` or
    ``finalize``): read it after that. ``step`` and ``finalize`` leave the
    carry they are given as it was.
    """
    damping = float(damping)
    waits: list = []
    waited: set = set()
    rounds = [0]

    def land(carry: StaleKCarry):
        """The landed parameters of the next round, as a flat buffer with a
        loss slot (the carry's own parameters when nothing is in flight)."""
        flat = _pack(carry.params)
        if carry.work is None:
            return flat
        carry.work.wait()
        if carry.launched not in waited:
            waited.add(carry.launched)
            waits.append((carry.launched, rounds[0]))
        agg = carry.inflight / dist.get_world_size(group)
        carry.loss.copy_(agg[-1])
        agg.mul_(damping)
        flat[:-1] += agg[:-1]
        return flat

    def init(params):
        return StaleKCarry(params, None, None, None, -1)

    def step(carry, batches):
        flat = land(carry)
        params = _rebuild(carry.params, flat[:-1])
        local, _ = _local_rows(batches, group)
        moved_flat = flat.clone()
        moved = _rebuild(carry.params, moved_flat)
        loss = _local_steps(loss_fn, moved, local, k, lr)
        moved_flat -= flat
        moved_flat[-1] = loss
        work = _reduce(moved_flat, group, counter, async_op=True)
        out = torch.full((), float("nan"), dtype=flat.dtype,
                         device=flat.device)
        launched = rounds[0]
        rounds[0] += 1
        return StaleKCarry(params, moved_flat, work, out, launched), out

    def finalize(carry):
        """Land the final round's still-in-flight aggregate."""
        return _rebuild(carry.params, land(carry)[:-1])

    return StaleKSolver(init=init, step=step, finalize=finalize, waits=waits)

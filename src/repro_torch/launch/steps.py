"""Train and serve step builders (the counterpart of
``repro.launch.steps``).

train_step: microbatched gradient accumulation with per-layer remat and one
AdamW update on float32 masters. The accumulation loop is the paper's CA
schedule: ``ca_k`` microbatches, one update and, data-parallel over a
``torch.distributed`` group (``Rules.group``), one gradient ``all_reduce``
of one flat buffer a step (``sync_every_microbatch``: one a microbatch).
The masters stay replicated, bitwise equal on every rank.

serve_step: one-token decode against the KV cache.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core.distributed import CollectiveCount
from repro_torch.kernels import registry
from repro_torch.models import decode_step, init_params, loss_fn
from repro_torch.optim import OptState, adamw_init, adamw_update, cosine_schedule
from repro_torch.tree import leaves, tree_map


class TrainState(NamedTuple):
    params: dict
    opt: OptState


def init_train_state(cfg, gen: torch.Generator, device=None) -> TrainState:
    """Float32 master weights from ``gen`` and zero moments."""
    params = init_params(cfg, gen, dtype=torch.float32, device=device)
    return TrainState(params=params, opt=adamw_init(params))


def _split(batch: dict, ca_k: int, rank: int = 0, world: int = 1):
    """This rank's rows of each of the ``ca_k`` microbatches of ``batch``:
    microbatch i is rows [i B/k, (i+1) B/k) of the global batch, as JAX
    splits it, and rank r of P takes the r-th of its P slices."""
    B = batch["tokens"].shape[0]
    if B % (ca_k * world):
        raise ValueError(f"batch {B} is not a multiple of ca_k {ca_k} x "
                         f"world {world}")
    n = B // ca_k // world
    return [{name: t[(i * world + rank) * n:(i * world + rank + 1) * n]
             for name, t in batch.items()} for i in range(ca_k)]


def _flat(tensors, extra: int, device):
    """One float32 buffer holding every tensor's numel plus ``extra``
    slots, and views of it shaped as ``tensors``."""
    sizes = [t.numel() for t in tensors]
    buf = torch.zeros(sum(sizes) + extra, dtype=torch.float32, device=device)
    views = [v.view(t.shape) for v, t in
             zip(torch.split(buf[:sum(sizes)], sizes), tensors)]
    return buf, views


def make_train_step(cfg, rules=None, *, ca_k: int = 8, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    remat: bool = True, sync_every_microbatch: bool = False,
                    counter: Optional[CollectiveCount] = None):
    """Returns train_step(state, batch) -> (state, metrics).

    The batch (B rows, the global batch) is split into ``ca_k``
    microbatches. CA schedule (default): the float32 masters are cast to
    one bf16 compute copy per step (the JAX package's hoisted parameter
    gather), each microbatch's bf16 gradients are summed into a float32
    accumulator, and one AdamW update follows. ``sync_every_microbatch=
    True`` is the classical schedule: one update per microbatch, each from
    the masters.

    ``rules`` (``dist.sharding.Rules``) with a process group of world P:
    rank r computes its slice of each microbatch (:func:`_split`). CA: the
    accumulator and the summed loss are one flat float32 buffer, reduced by
    one ``all_reduce`` a step and divided by P ca_k; classical: each
    microbatch's grads and loss, one ``all_reduce`` each, divided by P.
    Every all-reduce and its words are counted in ``counter``. Without a
    group (None, or rules at world 1 with no group) no collective runs.

    The state is updated in place (see ``repro_torch.optim.adamw``) and
    returned. Metrics (loss, grad_norm, lr) are device scalars: the step
    reads nothing back to the host. The registry policy active when the
    step is built is pinned for every call."""
    backend = registry.policy()
    group = rules.group if rules is not None else None
    world = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    if rules is not None and rules.dp_size != world:
        raise ValueError(f"rules: data axes of size {rules.dp_size} against "
                         f"a group of {world} ranks")

    def reduce(buf: torch.Tensor) -> None:
        # THE collective: one all-reduce of one contiguous buffer
        dist.all_reduce(buf, group=group)
        if counter is not None:
            counter.all_reduces += 1
            counter.words += buf.numel()

    def micro_grads(params, mb):
        loss = loss_fn(params, cfg, mb, remat=remat)
        return loss.detach(), torch.autograd.grad(loss, leaves(params))

    def _train_step(state: TrainState, batch: dict):
        lr = cosine_schedule(state.opt.step, peak_lr=peak_lr, warmup=warmup,
                             total=total_steps)
        micro = _split(batch, ca_k, rank, world)
        device = state.opt.step.device
        if sync_every_microbatch:
            losses, gnorms = [], []
            for mb in micro:
                p = tree_map(lambda t: t.detach().requires_grad_(),
                             state.params)
                loss, grads = micro_grads(p, mb)
                if group is not None:
                    buf, views = _flat(grads, 1, device)
                    for v, g in zip(views, grads):
                        v.copy_(g)
                    buf[-1] = loss
                    del grads
                    reduce(buf)
                    buf.div_(world)
                    grads, loss = views, buf[-1].clone()
                _, opt, gn = adamw_update(state.params, grads, state.opt,
                                          lr=lr)
                state = TrainState(state.params, opt)
                losses.append(loss)
                gnorms.append(gn)
            return state, dict(loss=torch.stack(losses).mean(),
                               grad_norm=torch.stack(gnorms).mean(), lr=lr)

        # CA: one bf16 compute copy for the step, float32 accumulation in
        # one flat buffer, its last slot the summed loss
        p_comp = tree_map(lambda t: t.detach().to(torch.bfloat16)
                          .requires_grad_(), state.params)
        buf, acc = _flat(leaves(state.params), 1, device)
        loss_sum = buf[-1]
        for mb in micro:
            loss, grads = micro_grads(p_comp, mb)
            loss_sum.add_(loss)
            for a, g in zip(acc, grads):
                a.add_(g)
            del grads
        del p_comp
        if group is not None:
            reduce(buf)
        buf.div_(world * ca_k)
        _, opt, gnorm = adamw_update(leaves(state.params), acc, state.opt,
                                     lr=lr)
        return TrainState(state.params, opt), dict(
            loss=loss_sum.clone(), grad_norm=gnorm, lr=lr)

    def train_step(state: TrainState, batch: dict):
        with registry.use(backend):
            return _train_step(state, batch)

    return train_step


def make_serve_step(cfg):
    """Returns serve_step(params, cache, tokens, positions=None,
    page_table=None) -> (next_tokens (B,1) int32, logits, cache).

    positions: optional (B,) per-slot decode depths (the continuous-batching
    engine); page_table: optional (B, pages_per_slot) int32 when the K/V
    leaves are a paged pool. The registry policy active when the step is
    built is pinned for every call (``auto`` still resolves by device).
    The next token is the greedy argmax; the engine's k-step block samples
    from the logits (``repro_torch.serve.sampling``) where a slot asks."""
    backend = registry.policy()

    def serve_step(params, cache, tokens, positions=None, page_table=None):
        with registry.use(backend):
            logits, cache = decode_step(params, cfg, cache, tokens,
                                        positions=positions,
                                        page_table=page_table)
        nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache

    return serve_step

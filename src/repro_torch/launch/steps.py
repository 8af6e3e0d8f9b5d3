"""Train and serve step builders (the counterpart of
``repro.launch.steps``, the single-device branch: ``rules is None``).

train_step: microbatched gradient accumulation with per-layer remat and one
AdamW update on float32 masters. The accumulation loop is the paper's CA
schedule: ``ca_k`` microbatches, one update (on a mesh, one gradient
collective). The sharded JAX branch comes with ``torch.distributed``
(ROADMAP).

serve_step: one-token decode against the KV cache.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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


def _split(batch: dict, ca_k: int):
    B = batch["tokens"].shape[0]
    if B % ca_k:
        raise ValueError(f"batch {B} is not a multiple of ca_k {ca_k}")
    return [{name: t[i * (B // ca_k):(i + 1) * (B // ca_k)]
             for name, t in batch.items()} for i in range(ca_k)]


def make_train_step(cfg, *, ca_k: int = 8, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    remat: bool = True, sync_every_microbatch: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).

    The batch (B rows) is split into ``ca_k`` microbatches. CA schedule
    (default): the float32 masters are cast to one bf16 compute copy per
    step (the JAX package's hoisted parameter gather), each microbatch's
    bf16 gradients are summed into a float32 accumulator, and one AdamW
    update follows. ``sync_every_microbatch=True`` is the classical
    schedule: one update per microbatch, each from the masters.

    The state is updated in place (see ``repro_torch.optim.adamw``) and
    returned. Metrics (loss, grad_norm, lr) are device scalars: the step
    reads nothing back to the host. The registry policy active when the
    step is built is pinned for every call."""
    backend = registry.policy()

    def micro_grads(params, mb):
        loss = loss_fn(params, cfg, mb, remat=remat)
        return loss.detach(), torch.autograd.grad(loss, leaves(params))

    def _train_step(state: TrainState, batch: dict):
        lr = cosine_schedule(state.opt.step, peak_lr=peak_lr, warmup=warmup,
                             total=total_steps)
        micro = _split(batch, ca_k)
        if sync_every_microbatch:
            losses, gnorms = [], []
            for mb in micro:
                p = tree_map(lambda t: t.detach().requires_grad_(),
                             state.params)
                loss, grads = micro_grads(p, mb)
                _, opt, gn = adamw_update(state.params, grads, state.opt,
                                          lr=lr)
                state = TrainState(state.params, opt)
                losses.append(loss)
                gnorms.append(gn)
            return state, dict(loss=torch.stack(losses).mean(),
                               grad_norm=torch.stack(gnorms).mean(), lr=lr)

        # CA: one bf16 compute copy for the step, float32 accumulation
        p_comp = tree_map(lambda t: t.detach().to(torch.bfloat16)
                          .requires_grad_(), state.params)
        acc = [torch.zeros_like(t, dtype=torch.float32)
               for t in leaves(state.params)]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=state.opt.step.device)
        for mb in micro:
            loss, grads = micro_grads(p_comp, mb)
            loss_sum = loss_sum + loss
            for a, g in zip(acc, grads):
                a.add_(g)
            del grads
        del p_comp
        for a in acc:
            a.div_(ca_k)
        _, opt, gnorm = adamw_update(leaves(state.params), acc, state.opt,
                                     lr=lr)
        return TrainState(state.params, opt), dict(
            loss=loss_sum / ca_k, grad_norm=gnorm, lr=lr)

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
    The next token is the greedy argmax; sampling comes with the rest of
    serving (ROADMAP queue 1 item 8)."""
    backend = registry.policy()

    def serve_step(params, cache, tokens, positions=None, page_table=None):
        with registry.use(backend):
            logits, cache = decode_step(params, cfg, cache, tokens,
                                        positions=positions,
                                        page_table=page_table)
        nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache

    return serve_step

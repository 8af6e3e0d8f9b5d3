"""Train and serve step builders (the counterpart of
``repro.launch.steps``).

train_step: microbatched gradient accumulation with per-layer remat and one
AdamW update on float32 masters. The accumulation loop is the paper's CA
schedule: ``ca_k`` microbatches, one update. On one device the state is
the port's parameter tree; under ``Rules`` bound to a process group it is
JAX's layout on the mesh (``dist.sharding.Layout``): float32 masters and
AdamW's moments sharded over the data axes (FSDP) and the model axis, one
gather a step into the bf16 compute copy, each microbatch's gradients
reduce-scattered into a sharded float32 accumulator, and the dense family
computing tensor-parallel over the model axis (``models.tp``).

serve_step: one-token decode against the KV cache; on a mesh, each rank
its batch rows, and the dense family tensor-parallel over the model axis
with the cache's rows split over it (JAX's ``cache_specs``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch import Unsupported
from repro_torch.roofline import category
from repro_torch.core.distributed import CollectiveCount
from repro_torch.dist.sharding import Layout
from repro_torch.kernels import registry
from repro_torch.models import decode_step, init_params, loss_fn, tp
from repro_torch.optim import OptState, adamw_init, adamw_update, cosine_schedule
from repro_torch.tree import leaves, tree_map


class TrainState(NamedTuple):
    params: dict
    opt: OptState


def layout(cfg, rules, training: bool = True) -> Layout:
    """The layout of ``cfg``'s parameters under ``rules`` (``training``
    False: of serving's weights, ``dist.sharding.Layout``)."""
    return Layout(init_params(cfg, None, device="meta"), rules, training)


def _sharded(rules) -> bool:
    """Whether ``rules`` lay the state out sharded: they are bound to a
    process group. Rules with no group stand for one device and its
    parameter tree; on a mesh of more devices they raise."""
    if rules is None or rules.group is not None:
        return rules is not None
    if rules.n_devices != 1:
        raise ValueError(f"rules: a mesh of {rules.n_devices} devices with "
                         f"no process group")
    return False


def init_train_state(cfg, gen: torch.Generator, device=None,
                     rules=None) -> TrainState:
    """Float32 master weights from ``gen`` and zero moments; with
    ``rules`` bound to a process group, this rank's shards of them in
    JAX's stacked layout (the full weights drawn first, as on one device,
    so every mesh starts from the same numbers)."""
    params = init_params(cfg, gen, dtype=torch.float32, device=device)
    return shard_train_state(cfg, TrainState(params, None), rules)


def shard_train_state(cfg, state: TrainState, rules) -> TrainState:
    """This rank's shard of a whole training state (the port's tree):
    masters and, when ``state.opt`` is given, its step and moments (else
    zero moments at step 0), in JAX's stacked layout under ``rules``;
    the port's tree as it is for rules with no process group (one
    device), as :func:`make_train_step` takes them."""
    if not _sharded(rules):
        return state if state.opt is not None else TrainState(
            params=state.params, opt=adamw_init(state.params))
    lay = layout(cfg, rules)
    params = lay.tree(lay.shard(state.params))
    if state.opt is None:
        return TrainState(params=params, opt=adamw_init(params))
    return TrainState(params=params, opt=OptState(
        step=state.opt.step.clone(), m=lay.tree(lay.shard(state.opt.m)),
        v=lay.tree(lay.shard(state.opt.v))))


def _split(batch: dict, ca_k: int, rank: int = 0, world: int = 1):
    """This rank's rows of each of the ``ca_k`` microbatches of ``batch``:
    microbatch i is rows [i B/k, (i+1) B/k) of the global batch, as JAX
    splits it, and data rank r of P takes the r-th of its P slices."""
    B = batch["tokens"].shape[0]
    if B % (ca_k * world):
        raise ValueError(f"batch {B} is not a multiple of ca_k {ca_k} x "
                         f"world {world}")
    n = B // ca_k // world
    return [{name: t[(i * world + rank) * n:(i * world + rank + 1) * n]
             for name, t in batch.items()} for i in range(ca_k)]


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

    ``rules`` None, or with no process group on a mesh of one device: one
    device, the port's parameter tree, no collective.
    ``rules`` (``dist.sharding.Rules``) bound to a process group: the state
    is this rank's shard of JAX's layout (:func:`init_train_state` or
    :func:`shard_train_state` with the same rules) and data rank r computes
    its slice of each microbatch (:func:`_split`). A CA step makes, over
    the rules' groups and counted in ``counter``:

    - one ``all_gather`` of the data-split masters, cast to bf16, into the
      compute copy;
    - ``ca_k`` ``reduce_scatter``: a microbatch's bf16 gradients of the
      data-split leaves into their shards, added to the float32
      accumulator (these two only when the layout splits a leaf over the
      data axes);
    - one ``all_reduce`` over the data group of the float32 sums of the
      leaves replicated over the data axes and the loss (every rank then
      holds the same bits of them);
    - one ``all_reduce`` of one float32 word over the mesh: the sum of
      squares (a leaf replicated over an axis counted on that axis's index
      0 alone), from which AdamW takes the global norm.

    The classical step makes each of them once a microbatch, its compute
    copy and gradients in float32 (JAX's classical step differentiates the
    masters themselves). With
    ``rules.tp_size`` past 1 the dense family computes tensor-parallel and
    DTensor adds the model axis's collectives inside the forward and
    backward (not counted here); the other families raise. At a mesh of
    one device the step is bitwise the single-device step.

    The state is updated in place (see ``repro_torch.optim.adamw``) and
    returned. Metrics (loss, grad_norm, lr) are device scalars: the step
    reads nothing back to the host. The registry policy active when the
    step is built is pinned for every call."""
    backend = registry.policy()
    if rules is not None and rules.tp_size > 1 and cfg.family != "dense":
        raise Unsupported(_tp_family(cfg))
    if rules is not None and (cfg.n_heads % rules.tp_size
                              or cfg.n_kv_heads % rules.tp_size):
        raise Unsupported(
            f"{cfg.name}: tensor parallelism splits attention heads, and "
            f"{cfg.n_heads} query and {cfg.n_kv_heads} kv heads do not "
            f"divide a model axis of {rules.tp_size} (ROADMAP queue 1 item "
            f"7(a))")
    if _sharded(rules):
        step = _sharded_step(cfg, rules, ca_k=ca_k, peak_lr=peak_lr,
                             warmup=warmup, total_steps=total_steps,
                             remat=remat,
                             sync_every_microbatch=sync_every_microbatch,
                             counter=counter)
    else:
        step = _single_step(cfg, ca_k=ca_k, peak_lr=peak_lr, warmup=warmup,
                            total_steps=total_steps, remat=remat,
                            sync_every_microbatch=sync_every_microbatch)

    def train_step(state: TrainState, batch: dict):
        with registry.use(backend):
            return step(state, batch)

    return train_step


def _single_step(cfg, *, ca_k, peak_lr, warmup, total_steps, remat,
                 sync_every_microbatch):
    def micro_grads(params, mb):
        loss = loss_fn(params, cfg, mb, remat=remat)
        return loss.detach(), torch.autograd.grad(loss, leaves(params))

    def step(state: TrainState, batch: dict):
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
        with category("compute_copy"):
            p_comp = tree_map(lambda t: t.detach().to(torch.bfloat16)
                              .requires_grad_(), state.params)
        with category("accumulator_staging"):
            acc = [torch.zeros(t.shape, dtype=torch.float32,
                               device=t.device)
                   for t in leaves(state.params)]
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=state.opt.step.device)
        for mb in micro:
            loss, grads = micro_grads(p_comp, mb)
            loss_sum.add_(loss)
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

    return step


def _sharded_step(cfg, rules, *, ca_k, peak_lr, warmup, total_steps, remat,
                  sync_every_microbatch, counter):
    lay = layout(cfg, rules)
    world, rank = rules.dp_size, rules.dp_rank
    counted = lay.counted()
    full = all(lf.local[:lf.lead] == lf.shape[:lf.lead] for lf in lay.leaves)
    split = rules.tp_size > 1
    wrap = tp.wrapper(rules.tp_mesh) if split else None

    def compute_copy(masters, dtype):
        flat = [t.requires_grad_() for t in
                lay.gather(masters, dtype, counter)]
        return flat, lay.unstack(flat, wrap)

    def micro_grads(flat, params, mb):
        with tp.loss_context(split):
            loss = loss_fn(params, cfg, mb, remat=remat)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        return loss.detach(), list(grads)

    def sq_norm(grads):
        """This rank's share of the sum of squares: in the single-device
        step's order (layer by layer) where the stacks are whole here."""
        if full:
            keep = {id(lf): c for lf, c in zip(lay.leaves, counted)}
            tree = lay.unstack(grads, lambda t, lf: t if keep[id(lf)]
                               else None)
            gs = [g for g in leaves(tree) if g is not None]
        else:
            gs = [g for g, c in zip(grads, counted) if c]
        return sum(torch.dot(g.float().reshape(-1), g.float().reshape(-1))
                   for g in gs)

    def reduce_replicated(buf) -> None:
        """The replicated leaves' gradients and the summed loss: one
        all_reduce over the data group."""
        dist.all_reduce(buf, group=rules.dp_group)
        if counter is not None:
            counter.all_reduces += 1
            counter.words += buf.numel()

    def global_norm(grads):
        """The global grad norm: one all_reduce of one word over the
        mesh."""
        buf = torch.as_tensor(sq_norm(grads), dtype=torch.float32,
                              device=grads[0].device).reshape(1)
        dist.all_reduce(buf, group=rules.group)
        if counter is not None:
            counter.all_reduces += 1
            counter.words += buf.numel()
        return torch.sqrt(buf[0])

    def step(state: TrainState, batch: dict):
        lr = cosine_schedule(state.opt.step, peak_lr=peak_lr, warmup=warmup,
                             total=total_steps)
        micro = _split(batch, ca_k, rank, world)
        masters = leaves(state.params)
        device = state.opt.step.device
        if sync_every_microbatch:
            losses, gnorms = [], []
            for mb in micro:
                # JAX's classical step differentiates the float32 masters
                flat, params = compute_copy(masters, torch.float32)
                loss, grads = micro_grads(flat, params, mb)
                del flat, params
                red = lay.reduce_scatter(grads, counter)
                rbuf, rviews = lay.replicated_buffer(device, extra=1)
                for i in lay.replicated:
                    if red[i] is not None:
                        rviews[i].copy_(red[i])
                rbuf[-1] = loss
                reduce_replicated(rbuf)
                grads = [(r if r is None else r.float()) if v is None else v
                         for r, v in zip(red, rviews)]
                del red
                for g in grads:
                    g.div_(world)
                gn = global_norm(grads)
                _, opt, _ = adamw_update(masters, grads, state.opt, lr=lr,
                                         gnorm=gn)
                state = TrainState(state.params, opt)
                losses.append(rbuf[-1] / world)
                gnorms.append(gn)
            return state, dict(loss=torch.stack(losses).mean(),
                               grad_norm=torch.stack(gnorms).mean(), lr=lr)

        # CA: one compute copy for the step; each microbatch's grads of
        # the split leaves reduce-scattered into the sharded float32
        # accumulator, the replicated leaves' summed here and all-reduced
        # once, with the loss, at the end of the step
        flat, params = compute_copy(masters, torch.bfloat16)
        rbuf, acc = lay.replicated_buffer(device, extra=1)
        with category("accumulator_staging"):
            for i in lay.sharded:
                acc[i] = torch.zeros(masters[i].shape, dtype=torch.float32,
                                     device=device)
        loss_sum = rbuf[-1]
        for mb in micro:
            loss, grads = micro_grads(flat, params, mb)
            loss_sum.add_(loss)
            for a, g in zip(acc, lay.reduce_scatter(grads, counter)):
                if g is not None:
                    a.add_(g)
            del grads
        del flat, params
        reduce_replicated(rbuf)
        for a in acc:
            a.div_(world * ca_k)
        gnorm = global_norm(acc)
        _, opt, _ = adamw_update(masters, acc, state.opt, lr=lr,
                                 gnorm=gnorm)
        return TrainState(state.params, opt), dict(
            loss=loss_sum / (world * ca_k), grad_norm=gnorm, lr=lr)

    return step


def serve_params(cfg, params: dict, rules=None) -> dict:
    """This rank's serving weights from the whole tree ``params`` (the
    port's, any dtype): on a model axis past 1, each leaf cut as
    ``param_specs(gather_fsdp=True)`` cuts it (the training's compute
    copy: split over the model axis, whole over the data axes) and wrapped
    as a DTensor on the model group's mesh (``models.tp.wrapper``), new
    tensors, so the caller may drop the whole tree; ``params`` itself
    otherwise (one device, or a data-only mesh: every rank holds them
    whole)."""
    if rules is None or rules.tp_size == 1:
        return params
    if cfg.family != "dense":
        raise Unsupported(_tp_family(cfg))
    lay = layout(cfg, rules, training=False)
    return lay.unstack(lay.shard(params, gathered=True),
                       tp.wrapper(rules.tp_mesh))


def _tp_family(cfg) -> str:
    return (f"{cfg.name}: tensor parallelism over the model axis, for "
            f"training and serving, is the dense family's so far; the "
            f"{cfg.family!r} family's is ROADMAP queue 1 item 7(a) (use a "
            f"data-only mesh, model = 1)")


def make_serve_step(cfg, rules=None, *, kv_rows: Optional[int] = None,
                    counter: Optional[CollectiveCount] = None):
    """Returns serve_step(params, cache, tokens, positions=None,
    page_table=None) -> (next_tokens (B,1) int32, logits, cache).

    ``rules``: the mesh to serve on (None: one device). On a mesh each
    rank decodes its own batch rows (its shard of the cache under
    ``dist.sharding.cache_specs``), with no collective over the data axes.
    On a model axis past 1 the dense family runs tensor-parallel: its
    weights are the rank's shards (:func:`serve_params`), q, k and v are
    replicated over the model axis, the rank that holds the new position's
    row writes it, each rank reads its own rows and the group merges the
    partials (``models.tp.merge_ranks``, one ``all_gather`` a layer,
    counted in ``counter``), and the logits are replicated before the
    pick. ``kv_rows``: the rows of one K/V row block of the whole cache
    (the page size, or the slot cache's depth), which ``cache_specs``
    splits over the model axis where the axis divides them (required on a
    model axis past 1). The other families raise on a model axis past 1
    (ROADMAP queue 1 item 7(a)), and a paged pool on a data axis past 1
    raises (pages over the data axes need the engine's scheduler across
    data ranks, item 7(d)).

    positions: optional (B,) per-slot decode depths (the continuous-batching
    engine); page_table: optional (B, pages_per_slot) int32 when the K/V
    leaves are a paged pool. The registry policy active when the step is
    built is pinned for every call (``auto`` still resolves by device).
    The next token is the greedy argmax; the engine's k-step block samples
    from the logits (``repro_torch.serve.sampling``) where a slot asks."""
    shard = None
    dp = 1
    if rules is not None and rules.n_devices > 1:
        if rules.group is None:
            raise ValueError(f"rules: a mesh of {rules.n_devices} devices "
                             f"with no process group")
        dp = rules.dp_size
        if rules.tp_size > 1:
            if cfg.family != "dense":
                raise Unsupported(_tp_family(cfg))
            if kv_rows is None:
                raise ValueError("make_serve_step: on a model axis past 1, "
                                 "give kv_rows (the page size or the slot "
                                 "cache's depth)")
            if kv_rows % rules.tp_size == 0:
                shard = tp.RowShard(rules.tp_rank, rules.tp_size,
                                    rules.tp_group, counter)
    backend = registry.policy()

    def serve_step(params, cache, tokens, positions=None, page_table=None):
        if page_table is not None and dp > 1:
            raise Unsupported(
                f"{cfg.name}: a paged pool on a data axis of {dp}: its pages "
                f"over the data axes need the engine's scheduler across "
                f"data ranks (ROADMAP queue 1 item 7(d))")
        with registry.use(backend):
            logits, cache = decode_step(params, cfg, cache, tokens,
                                        positions=positions,
                                        page_table=page_table, shard=shard)
        nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache

    return serve_step

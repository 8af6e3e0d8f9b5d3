"""Tensor parallelism of the dense family over the model axis, through
DTensor: the counterpart of GSPMD partitioning ``repro.models`` on a mesh
whose ``model`` axis is past 1.

The training step hands the model its compute copy as DTensors on the
model group's 1-D ``DeviceMesh`` (``launch.steps``): a leaf is
``Shard(dim)`` where its ``gather_fsdp`` spec names ``model`` and
``Replicate()`` elsewhere. DTensor's sharding propagation then inserts the
collectives, at the layouts JAX's model constrains to:

- the residual stream and a block's output are replicated over the model
  axis (JAX: ``constrain(out, ("batch", None, None))``), and so is a norm
  gain before it scales (an all-gather of a (d,) vector);
- a product is laid out by its weight (:func:`matmul`): a weight split on
  its output dim (column-parallel) takes the replicated input and gives an
  output split on its last dim; one split on its input dim (row-parallel:
  ``w_down``, and ``wk``/``wv`` where d is their larger dim) takes the
  input split on its last dim and gives partial sums;
- q, k and v reach attention split on their heads (JAX: ``("batch", None,
  "tp", None)``), a reduce-scatter of k's and v's partial sums where their
  weights are row-parallel, so each rank holds the kv heads of its own
  query groups.

A hand-written kernel never sees a DTensor: attention (RoPE and the flash
kernels) runs on each rank's local heads (:func:`heads`,
:func:`from_heads`), the embedding lookup on the rank's vocabulary rows
(:func:`embedding`), and the loss is DTensor's vocab-parallel cross
entropy (:func:`cross_entropy`, inside :func:`loss_context`). Off the
model axis (plain tensors) every function here is the plain operation.

Serving on the model axis (the flash-decoding layout of JAX's
``cache_specs``: each rank holds a slice of every K/V row block) takes q,
k and v replicated instead (:func:`local`): every rank reads every head
of its own rows, so no head count need divide the axis. Each rank runs
``paged_decode`` over its rows with the lse, and the group gathers the
(o, lse) partials and merges them in rank order (:func:`merge_ranks`),
so every rank holds the same bits; the logits are replicated before the
pick, so every rank draws the same token. :class:`RowShard` names the
rank's place in that group. A forward whose heads do not divide the axis
(the dry run's prefill) takes the same replicated heads.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import Unsupported
from repro_torch.kernels.flash_attention import ref as fa_ref


def is_tp(t) -> bool:
    return isinstance(t, DTensor)


def _place(x: DTensor, p) -> DTensor:
    return x if x.placements[0] == p else x.redistribute(placements=[p])


def replicate(x):
    """``x`` replicated over the model axis (a plain tensor as it is)."""
    return _place(x, Replicate()) if is_tp(x) else x


#: whether a product split on its input dim sums its partials in float32
#: (:func:`float32_partials`)
_F32_PARTIALS = [False]


@contextlib.contextmanager
def float32_partials():
    """Inside: a product whose weight is split on its input dim (:func:`
    matmul`) sums the ranks' partial products in float32 and rounds the
    sum once to the stream's dtype, as one device's GEMM rounds its
    float32 sum once, instead of summing partials each rounded to bf16.
    The decode step on the model axis runs inside it, so its logits stay
    within the float32 summation order of the single card's."""
    prev = _F32_PARTIALS[0]
    _F32_PARTIALS[0] = True
    try:
        yield
    finally:
        _F32_PARTIALS[0] = prev


def matmul(x, w):
    """``x @ w``; with ``w`` a DTensor, ``x`` laid out as the product
    wants it first: split on its last dim for a weight split on its input
    dim, replicated otherwise; under :func:`float32_partials` the former's
    partial products summed in float32 and returned replicated."""
    if not is_tp(w):
        return x @ w
    p = w.placements[0]
    row = isinstance(p, Shard) and p.dim == 0
    if row and _F32_PARTIALS[0]:
        part = _place(x, Shard(x.ndim - 1)).to_local().float() \
            @ w.to_local().float()
        out = DTensor.from_local(part, w.device_mesh, [Partial()],
                                 run_check=False)
        return _place(out, Replicate()).to(x.dtype)
    return _place(x, Shard(x.ndim - 1) if row else Replicate()) @ w


def local(x) -> torch.Tensor:
    """``x`` whole on this rank as a plain tensor: a DTensor replicated
    first (a plain tensor as it is)."""
    return replicate(x).to_local() if is_tp(x) else x


def replicated(x: torch.Tensor, like: DTensor) -> DTensor:
    """A plain tensor every rank holds whole, as the replicated DTensor on
    ``like``'s mesh."""
    return DTensor.from_local(x, like.device_mesh, [Replicate()],
                              run_check=False)


def divides(n_heads: int, n_kv: int, like) -> bool:
    """Whether both head counts divide the model axis ``like`` (a DTensor)
    lies over: then a forward splits attention by heads."""
    m = like.device_mesh.size()
    return n_heads % m == 0 and n_kv % m == 0


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's place in the model group that splits every K/V row
    block of a decode cache (``dist.sharding.cache_shard``): its index
    ``rank`` of ``size`` ranks in ``group``. ``counter`` (a
    ``core.distributed.CollectiveCount``), when given, counts the merge's
    gathers."""
    rank: int
    size: int
    group: Any = None
    counter: Any = None


def merge_ranks(o: torch.Tensor, lse: torch.Tensor,
                shard: RowShard) -> torch.Tensor:
    """The decode attention over the whole group's rows from this rank's
    partial o (B, 1, Hq, D) and lse (B, Hq) float32: one
    ``all_gather_into_tensor`` of both, in float32, over the group, then
    ``ref.merge_partials`` in rank order, rounded once to o's dtype. A
    gather, not an all-reduce: every rank merges the same bits in the same
    order, so all hold the same result."""
    send = torch.cat([o.float().reshape(-1), lse.reshape(-1)])
    recv = torch.empty(shard.size * send.numel(), dtype=send.dtype,
                       device=send.device)
    dist.all_gather_into_tensor(recv, send, group=shard.group)
    if shard.counter is not None:
        shard.counter.all_gathers += 1
        shard.counter.words += recv.numel()
    recv = recv.view(shard.size, -1)
    n = o.numel()
    parts = recv[:, :n].view(shard.size, *o.shape)
    return fa_ref.merge_partials(parts, recv[:, n:].view(
        shard.size, *lse.shape)).to(o.dtype)


def heads(t: DTensor) -> torch.Tensor:
    """(B, S, H, D) split on H: this rank's local heads, a plain tensor."""
    n = t.device_mesh.size()
    if t.shape[2] % n:
        raise Unsupported(
            f"tensor parallelism splits attention heads: {t.shape[2]} heads "
            f"over a model axis of {n}")
    return _place(t, Shard(2)).to_local()


def from_heads(o: torch.Tensor, like: DTensor) -> DTensor:
    """This rank's local heads (B, S, h, D) as the DTensor split on H."""
    return DTensor.from_local(o, like.device_mesh, [Shard(2)],
                              run_check=False)


def embedding(tokens: torch.Tensor, table: DTensor) -> DTensor:
    """``F.embedding(tokens, table)``, replicated. A table split on its
    vocabulary rows is read on this rank's rows, the others' tokens
    zeroed, and the partial rows summed: exactly the lookup."""
    mesh = table.device_mesh
    p = table.placements[0]
    if isinstance(p, Shard) and p.dim == 0:
        local = table.to_local()
        rows = local.shape[0]
        idx = tokens.long() - rows * mesh.get_local_rank()
        inside = (idx >= 0) & (idx < rows)
        out = F.embedding(idx.clamp(0, rows - 1), local) * \
            inside[..., None].to(local.dtype)
        return _place(DTensor.from_local(out, mesh, [Partial()],
                                         run_check=False), Replicate())
    tok = DTensor.from_local(tokens.long(), mesh, [Replicate()],
                             run_check=False)
    return replicate(F.embedding(tok, table))


def cross_entropy(logits: DTensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean next-token cross entropy of (B, S, V) logits, split on V,
    as a plain scalar: ``F.cross_entropy`` in float32 under DTensor's
    ``loss_parallel``, which the caller enters around the forward and the
    backward (:func:`loss_context`)."""
    mesh = logits.device_mesh
    lab = DTensor.from_local(labels.long().reshape(-1), mesh, [Replicate()],
                             run_check=False)
    logits = _place(logits, Shard(logits.ndim - 1))
    return F.cross_entropy(logits.float().flatten(0, 1), lab).to_local()


def loss_context(on: bool):
    """DTensor's ``loss_parallel`` when ``on`` (around the forward and
    backward of :func:`cross_entropy`), else nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.distributed.tensor.parallel import loss_parallel
    return loss_parallel()


def wrapper(mesh):
    """``Layout.unstack``'s ``wrap`` for the compute copy: each local view
    a DTensor on ``mesh``, split where its ``gather_fsdp`` spec names the
    model axis."""
    def wrap(t: torch.Tensor, leaf) -> DTensor:
        d = leaf.model_dim
        if d is not None and d < leaf.lead:
            raise Unsupported(
                f"a layer stack {leaf.shape} split over the model axis on "
                f"its stack dim ({leaf.gspec})")
        place = Replicate() if d is None else Shard(d - leaf.lead)
        return DTensor.from_local(t, mesh, [place], run_check=False)
    return wrap

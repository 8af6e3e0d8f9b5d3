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
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import Unsupported


def is_tp(t) -> bool:
    return isinstance(t, DTensor)


def _place(x: DTensor, p) -> DTensor:
    return x if x.placements[0] == p else x.redistribute(placements=[p])


def replicate(x):
    """``x`` replicated over the model axis (a plain tensor as it is)."""
    return _place(x, Replicate()) if is_tp(x) else x


def matmul(x, w):
    """``x @ w``; with ``w`` a DTensor, ``x`` laid out as the product
    wants it first: split on its last dim for a weight split on its input
    dim, replicated otherwise."""
    if not is_tp(w):
        return x @ w
    p = w.placements[0]
    row = isinstance(p, Shard) and p.dim == 0
    return _place(x, Shard(x.ndim - 1) if row else Replicate()) @ w


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

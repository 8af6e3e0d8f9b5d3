"""Elastic remesh: shrink the data-parallel group after node failures, the
counterpart of ``repro.dist.elastic``.

Follows the asynchronous-relaxation direction of Devarakonda et al.
(arXiv:1712.06047): rather than blocking until a failed host returns, the
runner rebuilds on the ranks that survive: on the largest (data, model)
mesh they fill with the model axis kept (:func:`largest_mesh_shape`), its
sharded state restored from the newest checkpoint into the new layout.
Losing ranks shrinks the data axis, which costs throughput, not
correctness (the CA-k schedule is batch-linear).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch.distributed as dist


def largest_mesh_shape(n_devices: int, model_size: int) -> Tuple[int, int]:
    """Largest (data, model) shape on ``n_devices`` that keeps the model axis.

    data = floor(n / model), clamped to >= 1 (a mesh never vanishes: with
    fewer devices than model shards the caller keeps the model axis and
    oversubscribes — largest_mesh_shape(8, 16) == (1, 16) states the target
    shape).
    """
    return (max(n_devices // model_size, 1), model_size)


def remesh(group=None, survivors: Optional[Sequence[int]] = None):
    """The process group over the surviving ranks of ``group`` (default:
    the default group), shrink-only.

    ``survivors``: the ranks of the default group that survive, a subset
    of ``group``'s; ``None`` means every rank of ``group`` survives (a
    restart on the same ranks). Every rank of the default group calls this
    (``dist.new_group`` is collective over it), the failed ones too while
    they can; a rank outside the survivors gets back
    ``dist.GroupMember.NON_GROUP_MEMBER`` and leaves the job. Returns the
    new group, or ``group`` itself when every rank survives.
    """
    members = sorted(dist.get_process_group_ranks(
        group if group is not None else dist.group.WORLD))
    keep = members if survivors is None else sorted(set(survivors))
    if not set(keep) <= set(members):
        raise ValueError(f"remesh is shrink-only: survivors {keep} are not "
                         f"all in the group {members}")
    if not keep:
        raise ValueError("remesh: no rank survives")
    if keep == members:
        return group
    return dist.new_group(ranks=keep)

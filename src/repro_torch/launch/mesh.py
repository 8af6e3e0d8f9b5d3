"""Process-group setup for the distributed solvers.

The JAX package builds device meshes for ``shard_map``: the production
16 x 16 TPU pod (and a 2 x 16 x 16 multi-pod one) and whatever the host
offers. The port has no mesh: it runs one process a card (or a CPU rank)
in a ``torch.distributed`` process group, the samples sharded across the
ranks (``core.distributed``), and the TPU pod's mesh has no analogue here.
:func:`init` joins the default group, with ``nccl`` for CUDA and ``gloo``
for the CPU, from the ``torchrun`` environment or from an explicit rank,
world size and store; :func:`shutdown` leaves it.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device


def init(device: Optional[str] = "cuda", *, rank: Optional[int] = None,
         world_size: Optional[int] = None, store=None) -> torch.device:
    """Join the default process group and return this rank's device.

    With ``rank`` and ``world_size`` given, the group meets at ``store`` (a
    ``torch.distributed.Store``; a ``FileStore`` for ranks in separate
    processes of one host); at world size 1 it defaults to an in-process
    ``HashStore``, which needs no network. Without them, the ``torchrun``
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) gives all of it. ``device`` "cuda" (the default) runs
    on card ``LOCAL_RANK`` (or rank modulo the cards) with ``nccl``, "cpu"
    with ``gloo``."""
    dev = resolve_device(device)
    if rank is None or world_size is None:
        if "RANK" not in os.environ:
            raise ValueError("mesh.init: give rank and world_size, or run "
                             "under torchrun (RANK and WORLD_SIZE unset)")
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        init_method = "env://"
    else:
        local, init_method = rank, None
        if store is None:
            if world_size != 1:
                raise ValueError("mesh.init: ranks in several processes "
                                 "need a store (e.g. a FileStore)")
            store = dist.HashStore()
    kw = dict(rank=rank, world_size=world_size)
    if dev.type == "cuda":
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method, **kw)
    else:
        dist.init_process_group(backend, store=store, **kw)
    return dev


def shutdown() -> None:
    """Leave the default process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()

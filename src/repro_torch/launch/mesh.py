"""Process-group setup and the meshes of the training and the
distributed solvers.

The JAX package builds device meshes: the production 16 x 16 TPU pod (and
a 2 x 16 x 16 multi-pod one) and whatever the host offers. The port runs
one process a card (or a CPU rank) in a ``torch.distributed`` process
group; a :class:`~repro_torch.dist.sharding.Mesh` names the group's ranks
on the mesh's axes in JAX's device order (``dist.sharding.make_rules``).
:func:`make_host_mesh` is JAX's rule for the devices at hand and
:func:`make_production_mesh` the pod's two shapes (no devices: the port
checks its specs on them). :func:`init` joins the default group, with
``nccl`` for CUDA and ``gloo`` for the CPU, from the ``torchrun``
environment or from an explicit rank, world size and store;
:func:`shutdown` leaves it.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.dist.sharding import Mesh


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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16), 256 chips; multi-pod: (pod=2,
    data=16, model=16), 512 chips (``repro.launch.mesh``'s shapes)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(n: Optional[int] = None, *,
                   tensor_parallel: bool = True) -> Mesh:
    """JAX's mesh for ``n`` devices (default: the default group's world
    size, 1 outside one): the model axis takes 4, 2 or 1 of them, the
    first that divides ``n``, and the data axis the rest. With
    ``tensor_parallel`` False (a family the port does not split over the
    model axis yet) it is the data-only (n, 1)."""
    if n is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
    model = next(m for m in (4, 2, 1) if n % m == 0) \
        if tensor_parallel else 1
    return Mesh(("data", "model"), (n // model, model))

"""Roofline terms of an eager program (the counterpart of
``repro.roofline.analysis``).

JAX analyses a compiled module. An eager PyTorch program has none, so
:func:`analyze` runs the program once under a ``TorchDispatchMode`` and
counts what it dispatches:

* a registry op (``kernels.registry``) by its work function: its FLOPs at
  its dtype's peak and its HBM bytes. The aten ops inside it (its plain
  version's on the CPU, its wrapper's allocations on the card) are not
  counted a second time;
* every other aten op: FLOPs by ``torch.utils.flop_counter``'s formulas
  (matmuls, convolutions, attention; 0 for the rest) at the peak of its
  first operand's dtype, bytes as its inputs read plus its outputs
  written, since eager PyTorch runs each op as its own kernel from HBM
  (a view moves nothing);
* c10d collectives, their buffers' bytes by kind and group size.

A DTensor op is counted by what it runs on this rank: the mode declines
it, and sees the local ops and the collectives DTensor issues for it (not
the stand-in ops of DTensor's sharding propagation).

compute term    = sum over ops of FLOPs / the peak of the op's dtype
memory term     = HBM bytes / HBM bandwidth
collective term = sum over collectives of the bytes a ring moves per
                  GPU / the link rate (NVLink inside a node, the network
                  past it)

``per_device_memory`` holds the card's ``max_memory_allocated`` over the
run on a card, and with a ``tracker`` (the dry run's fake tensors) the
peak of live storage bytes, split by what allocated them
(:class:`StorageTracker`).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import sys
import threading
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                         is_traceable_wrapper_subclass)
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import registry
from repro_torch.roofline.hw import H100, Chip

#: per-GPU traffic of a ring collective over n GPUs, as a share of its
#: buffer's bytes (all_reduce: reduce-scatter then all-gather)
_RING = {"all_reduce": lambda n: 2.0 * (n - 1) / n,
         "all_gather": lambda n: (n - 1) / n,
         "reduce_scatter": lambda n: (n - 1) / n,
         "all_to_all": lambda n: (n - 1) / n,
         "broadcast": lambda n: (n - 1) / n,
         "gather": lambda n: (n - 1) / n}

#: c10d and functional-collective op names -> kind
_KINDS = {"allreduce_": "all_reduce", "all_reduce": "all_reduce",
          "allreduce_coalesced_": "all_reduce",
          "_allgather_base_": "all_gather", "allgather_": "all_gather",
          "all_gather_into_tensor": "all_gather",
          "all_gather_into_tensor_out": "all_gather",
          "_reduce_scatter_base_": "reduce_scatter",
          "reduce_scatter_": "reduce_scatter",
          "reduce_scatter_tensor": "reduce_scatter",
          "alltoall_base_": "all_to_all", "all_to_all_single": "all_to_all",
          "broadcast_": "broadcast", "broadcast": "broadcast",
          "gather_": "gather"}

#: ops that move no data: aliases, and the metadata queries a tensor
#: subclass (a fake tensor) dispatches where a real one answers in C++
_FREE = {"detach", "alias", "lift_fresh", "_unsafe_view", "_reshape_alias",
         "unsafe_split", "unsafe_split_with_sizes", "size", "sym_size",
         "stride", "sym_stride", "storage_offset", "sym_storage_offset",
         "numel", "sym_numel", "dim", "is_contiguous", "sym_is_contiguous",
         "is_strides_like_format", "is_non_overlapping_and_dense"}


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_hbm: float
    bytes_collective: float
    collective_detail: dict
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    per_device_memory: dict
    #: calls of each registry op counted by its work function
    registry_ops: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _group_size(func, args) -> int:
    """The size of a collective's group, from its process group (c10d
    ops) or its group name (functional collectives)."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:
                continue       # a ReduceOp or an option, not the group
    if isinstance(args[-1], str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(args[-1]).size()
    raise ValueError(f"{func}: no process group among its arguments")


def _collective_bytes(kind: str, func, args) -> int:
    """The bytes of a collective's full buffer: the reduced tensor, the
    gathered output, the scattered input."""
    ts = _tensors(args)
    if kind == "all_gather" and func.namespace == "c10d":
        return _nbytes(ts[0]) if func._schema.name.endswith("base_") \
            else sum(_nbytes(t) for t in ts[:len(ts) // 2])
    if kind == "all_gather":               # functional: input, group size
        return _nbytes(ts[0]) * int(args[1])
    if kind == "reduce_scatter" and func.namespace == "c10d":
        return _nbytes(ts[-1]) if func._schema.name.endswith("base_") \
            else sum(_nbytes(t) for t in ts[len(ts) // 2:])
    if kind == "all_reduce" and func.namespace == "c10d":
        return sum(_nbytes(t) for t in ts)
    return _nbytes(ts[0])


_TAGS = threading.local()           # .stack: the open category() tags


@contextlib.contextmanager
def category(name: str):
    """Tag what this block allocates for :class:`StorageTracker`'s split at
    the peak: the code that allocates a compute copy, an accumulator or a
    staging buffer says so (``dist.sharding.Layout``'s collectives, the
    train steps). The innermost open tag applies; outside every tag an
    allocation is ``activations_temporaries``."""
    stack = _TAGS.__dict__.setdefault("stack", [])
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def current_category() -> str:
    """The innermost open :func:`category` tag of this thread, or
    ``activations_temporaries``."""
    stack = getattr(_TAGS, "stack", None)
    return stack[-1] if stack else "activations_temporaries"


class StorageTracker:
    """Live storage bytes over a run, and their peak: every storage an op
    outputs is counted from its first sight until it is freed (a weak
    reference to the storage, whose Python object PyTorch keeps while the
    storage lives), and at the peak the live bytes are split by what
    allocated them (the :func:`category` tag open at the allocation):
    ``state`` (storages registered before the run: the shards, the batch),
    ``compute_copy``, ``accumulator_staging`` and
    ``activations_temporaries`` (the rest: the model's activations, its
    gradients, the optimizer's temporaries).
    This is what ``torch.cuda.max_memory_allocated`` counts on the card
    (every tensor the program allocates), without the allocator's
    rounding of each block to 512 bytes."""

    #: how many large allocations :attr:`large` keeps
    N_LARGE = 64

    def __init__(self, large_bytes: int = 2 ** 30):
        self.live: Dict[int, tuple] = {}     # storage key -> (ref, n, cat)
        self.by_cat: Dict[str, int] = collections.Counter()
        self.total = 0
        self.peak = 0
        self.at_peak: Dict[str, int] = {}
        #: the program's first ``N_LARGE`` allocations of ``large_bytes``
        #: or more, in order: (bytes, live bytes before it, category),
        #: where a card short of memory would fail
        self.large: list = []
        self._large_bytes = large_bytes

    def add(self, t: torch.Tensor, category: Optional[str] = None) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        n = st.nbytes()
        cat = category or current_category()

        def gone(_ref, key=key, n=n, cat=cat):
            self.live.pop(key, None)
            self.total -= n
            self.by_cat[cat] -= n
        self.live[key] = (weakref.ref(st, gone), n, cat)
        if category is None and n >= self._large_bytes \
                and len(self.large) < self.N_LARGE:
            self.large.append((n, self.total, cat))
        self.total += n
        self.by_cat[cat] += n
        if self.total > self.peak:
            self.peak = self.total
            self.at_peak = {k: v for k, v in self.by_cat.items() if v}


def _propagating() -> bool:
    """Whether DTensor's sharding propagation is running an op on stand-in
    tensors of the global shapes (to learn the output's layout), which
    the card never runs."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


class _Counter(TorchDispatchMode):
    """Counts FLOPs, bytes and collectives (see the module docstring) and,
    with a tracker, live storage."""

    def __init__(self, chip: Chip, tracker: Optional[StorageTracker]):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.chip, self.tracker = chip, tracker
        self.flop_registry = flop_registry
        self.flops = self.t_compute = self.bytes = 0.0
        self.collectives: Dict[str, int] = collections.Counter()
        self.t_collective = 0.0
        self.registry_ops: Dict[str, int] = collections.Counter()
        self._inside = 0
        self._subclass = False

    @contextlib.contextmanager
    def registry_op(self, name, args, kwargs):
        """Around one registry op's impl (``registry.dispatch``, while
        ``registry.counting(self)`` is open): count its work function's
        Work, and none of the aten ops inside."""
        self._inside += 1
        try:
            if self._inside == 1:
                w = registry.work(name, *args, **kwargs)
                self.flops += w.flops
                self.t_compute += w.flops / self.chip.peak(w.dtype)
                self.bytes += w.bytes
                self.registry_ops[name] += 1
            yield
        finally:
            self._inside -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(is_traceable_wrapper_subclass(t) for t in
               tree_flatten((args, kwargs))[0]):
            # a DTensor op: declined, so DTensor's own dispatch runs, and
            # this mode sees the local ops and collectives it issues
            self._subclass = True
            return NotImplemented
        out = func(*args, **kwargs)
        if self._subclass and _propagating():
            return out
        if self.tracker is not None:
            for t in _tensors(out):
                self.tracker.add(t)
        if self._inside:
            return out
        name = func._schema.name.split("::")[-1]
        if func.namespace in ("c10d", "_c10d_functional",
                              "_c10d_functional_autograd"):
            kind = _KINDS.get(name)
            if kind is not None:
                n = _group_size(func, args)
                nbytes = _collective_bytes(kind, func, args)
                self.collectives[f"{kind}/{n}"] += nbytes
                if n > 1:
                    self.t_collective += (_RING[kind](n) * nbytes
                                          / self.chip.link_bw(n))
            return out
        if func.is_view or name in _FREE or func.namespace == "prim":
            return out
        packet = func.overloadpacket
        ins = _tensors((args, kwargs))
        if packet in self.flop_registry and ins:
            f = float(self.flop_registry[packet](*args, **kwargs,
                                                 out_val=out))
            self.flops += f
            self.t_compute += f / self.chip.peak(ins[0].dtype)
        self.bytes += sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in _tensors(out))
        return out


def analyze(fn, *args, chip: Chip = H100, tracker: Optional[StorageTracker]
            = None, **kwargs) -> Roofline:
    """Run ``fn(*args, **kwargs)`` once and return its :class:`Roofline`.
    On a card ``per_device_memory`` holds ``max_memory_allocated`` over the
    run (its peak statistics reset first); with ``tracker`` (the dry run,
    whose fake tensors have no memory) the tracker's peak and its split."""
    on_card = any(t.is_cuda for t in _tensors((args, kwargs)))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    mode = _Counter(chip, tracker)
    with mode, registry.counting(mode):
        fn(*args, **kwargs)
    mem = {}
    if on_card:
        torch.cuda.synchronize()
        mem["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    if tracker is not None:
        mem.update(peak_live_bytes=tracker.peak, at_peak=dict(
            tracker.at_peak), large_allocations=list(tracker.large))
    t_m = mode.bytes / chip.hbm_bw
    terms = {"compute": mode.t_compute, "memory": t_m,
             "collective": mode.t_collective}
    return Roofline(flops=mode.flops, bytes_hbm=mode.bytes,
                    bytes_collective=float(sum(mode.collectives.values())),
                    collective_detail=dict(mode.collectives),
                    t_compute=mode.t_compute, t_memory=t_m,
                    t_collective=mode.t_collective,
                    bottleneck=max(terms, key=terms.get),
                    per_device_memory=mem,
                    registry_ops=dict(mode.registry_ops))


def model_flops(cfg, shape, n_params_active: int, kind: str) -> float:
    """MODEL_FLOPS = 6 N D (train) or 2 N D (prefill, decode); D the tokens
    processed (``repro.roofline.analysis.model_flops``)."""
    if kind == "train":
        return 6.0 * n_params_active * shape.global_batch * shape.seq_len
    if kind == "prefill":
        return 2.0 * n_params_active * shape.global_batch * shape.seq_len
    return 2.0 * n_params_active * shape.global_batch


def mfu(model_flops_: float, seconds: float, chip: Chip = H100) -> float:
    """The step's model-FLOP share: model FLOPs over (measured seconds x
    the bf16 tensor-core peak)."""
    return model_flops_ / (seconds * chip.peak_flops_bf16)

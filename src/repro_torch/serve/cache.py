"""Slot-based cache pool over the ``init_cache`` layout (the counterpart of
``repro.serve.cache``).

A *slot* is one batch row of the decode cache from
``repro_torch.models.init_cache``. The pool owns slot bookkeeping
(allocate / free / defrag) and the slot operations on the cache; the engine
owns the cache itself and threads it through the k-step decode block.

The batch axis of every leaf is declared, not inferred: the dense cache is
``pos`` (scalar, no batch axis) and ``layers`` k/v (n_layers, B, max_len,
Hkv, Dh), batch axis 1. (JAX infers it by diffing ``eval_shape``s at two
batch sizes, to cover every family's layout.) Slot operations write the
cache tensors in place, so the views a caller holds stay valid.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, to_device
from repro_torch.models import init_cache
from repro_torch.models.transformer import require_supported

_NO_BATCH = -1


def tree_map(fn, tree, *rest):
    """Apply ``fn(leaf, *rest_leaves)`` over nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


class SlotError(RuntimeError):
    """Invalid slot transition (double allocate/free)."""


def require_servable(cfg) -> None:
    """Raise for a family the engine's pools do not hold yet: they hold
    the dense family's attention K/V. The other families' model runs
    (classic decode, ``launch.serve --engine off``); their pools and
    admission (the recurrent leaves of mamba2 and zamba2, MoE, whisper's
    cross K/V, qwen2-vl's prefix) come with the rest of serving."""
    require_supported(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: serving family {cfg.family!r} through the engine "
            f"is not ported yet; its pools and admission come with ROADMAP "
            f"queue 1 item 8 (the rest of serving)")


class CachePool:
    """Bookkeeping + slot ops for a ``num_slots``-row decode cache on
    ``device`` (``cuda`` unless the caller names another; raises without a
    card, as the engine does)."""

    def __init__(self, cfg, num_slots: int, max_len: int, *,
                 device=None):
        require_servable(cfg)
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.cfg = cfg
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.device = resolve_device(device)
        self.batch_axes = dict(pos=_NO_BATCH, layers=dict(k=1, v=1))
        # min-heap: lowest-index-first allocation keeps live slots packed at
        # the front, and free stays O(log n) instead of a full re-sort
        self._free: List[int] = list(range(num_slots))
        self._owner: Dict[int, str] = {}

    # ----------------------------------------------------------- construction
    def make_cache(self) -> dict:
        """Fresh pool cache; ownership passes to the caller."""
        return init_cache(self.cfg, self.num_slots, self.max_len,
                          device=self.device)

    # ------------------------------------------------------------ bookkeeping
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def live_count(self) -> int:
        return len(self._owner)

    def live_slots(self) -> List[int]:
        return sorted(self._owner)

    def allocate(self, request_id: str) -> int:
        if not self._free:
            raise SlotError("cache pool exhausted")
        slot = heapq.heappop(self._free)
        assert slot not in self._owner, "free list / owner map out of sync"
        self._owner[slot] = request_id
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._owner:
            raise SlotError(f"slot {slot} is not allocated")
        del self._owner[slot]
        heapq.heappush(self._free, slot)

    def fragmentation(self) -> float:
        """Hole fraction of the occupied span [0, max live slot]."""
        if not self._owner:
            return 0.0
        span = max(self._owner) + 1
        return 1.0 - len(self._owner) / span

    # -------------------------------------------------------------- slot ops
    def zero_slot(self, cache: dict, slot: int) -> dict:
        """Zero one slot's rows in place (for attention the stale rows are
        already invisible behind per-slot kv_valid; JAX zeroes them too)."""
        def f(leaf, ax):
            if ax != _NO_BATCH:
                leaf.select(ax, slot).zero_()
            return leaf
        return tree_map(f, cache, self.batch_axes)

    def set_slot(self, cache: dict, slot: int, row_cache: dict) -> dict:
        """Write a batch=1 cache into a slot, in place."""
        def f(leaf, row, ax):
            if ax != _NO_BATCH:
                leaf.select(ax, slot).copy_(row.select(ax, 0))
            return leaf
        return tree_map(f, cache, row_cache, self.batch_axes)

    def defrag(self, cache: dict) -> Tuple[dict, List[int], Dict[int, int]]:
        """Compact live slots to the lowest indices, preserving contents.

        Returns ``(cache, perm, mapping)``: ``perm`` is the old-slot
        permutation applied along every batch axis (new row i holds old row
        ``perm[i]``) — callers apply the same :meth:`take_rows` to their
        per-slot side arrays; ``mapping`` is old->new for the live slots.
        The cache tensors are permuted in place.
        """
        live = self.live_slots()
        perm = live + [s for s in range(self.num_slots) if s not in self._owner]
        mapping = {old: new for new, old in enumerate(live)}
        perm_dev = to_device(np.asarray(perm, np.int64), self.device)

        def f(leaf, ax):
            if ax != _NO_BATCH:
                leaf.copy_(leaf.index_select(ax, perm_dev))
            return leaf

        cache = tree_map(f, cache, self.batch_axes)
        self._owner = {mapping[s]: rid for s, rid in self._owner.items()}
        # ascending range is already a valid min-heap
        self._free = list(range(len(live), self.num_slots))
        return cache, perm, mapping

    def take_rows(self, per_slot: torch.Tensor, perm) -> torch.Tensor:
        """Apply a defrag permutation to a (num_slots, ...) device tensor."""
        idx = to_device(np.asarray(perm, np.int64), per_slot.device)
        return per_slot.index_select(0, idx)

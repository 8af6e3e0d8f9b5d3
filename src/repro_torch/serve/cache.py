"""Slot-based cache pool over the ``init_cache`` layouts (the counterpart of
``repro.serve.cache``).

A *slot* is one batch row of the decode cache from
``repro_torch.models.init_cache``: attention K/V rows for the attention
families, the recurrent (conv, ssm) state for mamba2 and zamba2 (and
zamba2's shared-attention K/V), self-attention rows and cross-attention K/V
for whisper. The pool owns slot bookkeeping (allocate / free / defrag) and
the slot operations on the cache; the engine owns the cache itself and
threads it through the k-step decode block.

The batch axis of every leaf is *inferred*, not declared per family: the
pool builds ``init_cache`` on the ``meta`` device at two batch sizes and
diffs the shapes (JAX diffs ``eval_shape``s), so zamba2's
``(n_super, period, B, ...)`` stacked state and whisper's
``(n_layers, B, enc_len, ...)`` cross cache need no special cases. Slot
operations write the cache tensors in place, so the views a caller holds
stay valid.

RNG state: each slot also carries a per-request PRNG key (``seed_slot`` /
``set_slot_key`` / ``slot_keys``) that the sampled decode path draws from
(``repro_torch.serve.sampling``). The key is request state, kept on the
host and never fetched from the device: it is seeded at admission, zeroed
on free, and follows the request through defrag, which makes sampled token
streams independent of slot placement.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, to_device
from repro_torch.models import init_cache
from repro_torch.models.transformer import require_supported, slot_rows

_NO_BATCH = -1


def tree_map(fn, tree, *rest):
    """Apply ``fn(leaf, *rest_leaves)`` over nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def meta_cache(cfg, batch: int, max_len: int, enc_len: Optional[int]):
    """``init_cache`` on the ``meta`` device: shapes and dtypes only."""
    return init_cache(cfg, batch, max_len, device="meta", enc_len=enc_len)


def _batch_axes(cfg, max_len: int, enc_len: Optional[int]) -> dict:
    """Tree of batch-axis indices (``_NO_BATCH`` for batchless leaves)."""
    a = meta_cache(cfg, 2, max_len, enc_len)
    b = meta_cache(cfg, 3, max_len, enc_len)

    def diff(x, y):
        axes = [i for i, (p, q) in enumerate(zip(x.shape, y.shape)) if p != q]
        assert len(axes) <= 1, f"ambiguous batch axis for shape {x.shape}"
        return axes[0] if axes else _NO_BATCH

    return tree_map(diff, a, b)


class SlotError(RuntimeError):
    """Invalid slot transition (double allocate/free)."""


class CachePool:
    """Bookkeeping + slot ops for a ``num_slots``-row decode cache on
    ``device`` (``cuda`` unless the caller names another; raises without a
    card, as the engine does). ``enc_len``: whisper's encoder length (the
    cross K/V rows), ignored by the other families."""

    def __init__(self, cfg, num_slots: int, max_len: int, *,
                 enc_len: Optional[int] = None, device=None):
        require_supported(cfg)
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.cfg = cfg
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.enc_len = enc_len
        self.device = resolve_device(device)
        self.batch_axes = _batch_axes(cfg, self.max_len, enc_len)
        # min-heap: lowest-index-first allocation keeps live slots packed at
        # the front, and free stays O(log n) instead of a full re-sort
        self._free: List[int] = list(range(num_slots))
        self._owner: Dict[int, str] = {}
        # per-slot PRNG key words (jax.random.PRNGKey rows) for sampling
        self._keys = np.zeros((num_slots, 2), np.uint32)

    # ----------------------------------------------------------- construction
    def make_cache(self) -> dict:
        """Fresh pool cache; ownership passes to the caller. Its K/V rows
        are ``max_len`` rounded up to whole pages of the decode's slot view
        (``models.transformer.slot_rows``); the rows past ``max_len`` are
        never read."""
        return init_cache(self.cfg, self.num_slots, slot_rows(self.max_len),
                          device=self.device, enc_len=self.enc_len)

    # ------------------------------------------------------------ bookkeeping
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def live_count(self) -> int:
        return len(self._owner)

    def live_slots(self) -> List[int]:
        return sorted(self._owner)

    def owner(self, slot: int) -> Optional[str]:
        return self._owner.get(slot)

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
        self._keys[slot] = 0               # request key dies with the request
        heapq.heappush(self._free, slot)

    # ------------------------------------------------------------- rng keys
    def seed_slot(self, slot: int, seed: int) -> None:
        """Bind a slot's PRNG key to a request seed (sampled decode): the
        threefry2x32 layout of ``jax.random.PRNGKey``, [seed >> 32,
        seed & 0xffffffff], built on the host. The key survives defrag
        with the request and is zeroed when the slot is freed."""
        if slot not in self._owner:
            raise SlotError(f"slot {slot} is not allocated")
        self._keys[slot] = np.array([seed >> 32, seed & 0xFFFFFFFF],
                                    np.uint32)

    def set_slot_key(self, slot: int, key) -> None:
        """Bind a slot to pre-derived raw key words ((2,) uint32). The n>1
        fan-out path derives stream i's key as ``host_fold_in(base_key,
        i)``, on the host as :meth:`seed_slot` does."""
        if slot not in self._owner:
            raise SlotError(f"slot {slot} is not allocated")
        self._keys[slot] = np.asarray(key, np.uint32).reshape(2)

    @property
    def slot_keys(self) -> np.ndarray:
        """(num_slots, 2) uint32 per-slot key words (zeros for greedy and
        free slots)."""
        return self._keys

    def fragmentation(self) -> float:
        """Hole fraction of the occupied span [0, max live slot]."""
        if not self._owner:
            return 0.0
        span = max(self._owner) + 1
        return 1.0 - len(self._owner) / span

    # -------------------------------------------------------------- slot ops
    def zero_slot(self, cache: dict, slot: int) -> dict:
        """Zero one slot's rows in place (required for recurrent state
        reuse; for attention the stale rows are already invisible behind
        per-slot kv_valid)."""
        def f(leaf, ax):
            if ax != _NO_BATCH:
                leaf.select(ax, slot).zero_()
            return leaf
        return tree_map(f, cache, self.batch_axes)

    def set_slot(self, cache: dict, slot: int, row_cache: dict) -> dict:
        """Write a batch=1 cache (whisper's cross K/V prefill) into a slot,
        in place, in each leaf's dtype."""
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
        self._keys = self._keys[np.asarray(perm)]   # keys follow their request
        return cache, perm, mapping

    def take_rows(self, per_slot: torch.Tensor, perm) -> torch.Tensor:
        """Apply a defrag permutation to a (num_slots, ...) device tensor."""
        idx = to_device(np.asarray(perm, np.int64), per_slot.device)
        return per_slot.index_select(0, idx)

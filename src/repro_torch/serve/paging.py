"""Paged KV cache pool (the counterpart of ``repro.serve.paging``'s
``PagedCachePool``).

Every attention K/V leaf trades its ``(n_layers, num_slots, max_len, ...)``
row layout for a flat page pool ``(n_layers, num_pages, page_size, ...)``
plus a host-side per-slot page table ``(num_slots, pages_per_slot) int32``.
A slot's logical position ``p`` lives at pool page ``table[slot, p //
page_size]``, row ``p % page_size``: the decode block scatters new K/V
through the table and the ``paged_attention`` op reads through it, so cache
capacity is however many pages are actually written.

Page 0 is a reserved scratch page: freeing a slot zeroes its table row on
the host, so the stale writes a finished slot keeps issuing inside a k-step
block divert into page 0, and reads never see it because every read is
masked by ``kv_valid``. Retiring a request is therefore a host-only table
edit. Pages are refcounted; ``defrag_pages`` compacts live pages to the
front of the pool by a permutation, remapping the tables through the same
lookup table.

Quantized pages (``kv_dtype="int8"``): the K/V leaves store int8 codes
with float32 scale siblings ``k_scale``/``v_scale`` (n_layers, num_pages,
page_size, Hkv), one scale per page row and KV head (symmetric absmax over
head_dim). Quantization happens on scatter (``models.blocks``) and both
``paged_attention`` impls dequantize on read. An int8 page plus its scales
costs about half the bytes of the bf16 page, so the default ``num_pages``
doubles. ``kv_dtype="f32"`` keeps the ``init_cache`` dtypes (bf16 K/V).

The dense layout is known, so the page axis of each leaf is declared (axis
1 of every ``layers`` leaf), not inferred. The radix-trie prefix cache,
copy-on-write and the fan-out paths come with the rest of serving (ROADMAP
queue 1 item 8).
"""
from __future__ import annotations

import heapq
from typing import List, Optional

import numpy as np
import torch

from repro_torch import to_device
from repro_torch.serve.cache import CachePool, SlotError, _NO_BATCH, tree_map


class PageError(RuntimeError):
    """Page pool exhausted (or invalid page transition)."""


class PagedCachePool(CachePool):
    """CachePool whose attention K/V leaves live in a shared page pool.

    Slot bookkeeping (allocate/free/owner/row-defrag) is inherited; the
    paged leaves are taken out of ``batch_axes`` so every inherited slot op
    skips them, and this class adds the page-table layer on top.
    """

    def __init__(self, cfg, num_slots: int, max_len: int, *,
                 page_size: int, num_pages: Optional[int] = None,
                 kv_dtype: str = "f32", device=None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if kv_dtype not in ("f32", "int8"):
            raise ValueError(
                f"kv_dtype must be 'f32' or 'int8', got {kv_dtype!r}")
        super().__init__(cfg, num_slots, max_len, device=device)
        self.page_size = int(page_size)
        self.pages_per_slot = -(-self.max_len // self.page_size)   # ceil
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == "int8"
        # +1 for the reserved scratch page 0; the default backs every slot
        # to full depth, doubled for int8 pages (about half the bytes each)
        if num_pages is None:
            num_pages = 1 + self.num_slots * self.pages_per_slot * \
                (2 if self.quantized else 1)
        self.num_pages = int(num_pages)
        if self.num_pages < 2:
            raise ValueError("num_pages must cover scratch + one real page")
        names = ("k", "v", "k_scale", "v_scale") if self.quantized \
            else ("k", "v")
        # page axis of each paged leaf; they leave the slot world
        self.page_axes = dict(pos=_NO_BATCH, layers={n: 1 for n in names})
        self.batch_axes = dict(pos=_NO_BATCH,
                               layers={n: _NO_BATCH for n in names})
        self._tables = np.zeros((self.num_slots, self.pages_per_slot),
                                np.int32)
        self._n_pages = np.zeros((self.num_slots,), np.int32)
        self._ref = np.zeros((self.num_pages,), np.int32)
        self._ref[0] = 1                      # scratch page is always live
        self._free_pages: List[int] = list(range(1, self.num_pages))

    # ----------------------------------------------------------- construction
    def _leaf_specs(self) -> dict:
        """name -> (shape, dtype) of every paged leaf."""
        cfg = self.cfg
        shp = (cfg.n_layers, self.num_pages, self.page_size, cfg.n_kv_heads,
               cfg.head_dim)
        if not self.quantized:
            return dict(k=(shp, torch.bfloat16), v=(shp, torch.bfloat16))
        return dict(k=(shp, torch.int8), v=(shp, torch.int8),
                    k_scale=(shp[:-1], torch.float32),
                    v_scale=(shp[:-1], torch.float32))

    def make_cache(self) -> dict:
        layers = {}
        for name, (shape, dtype) in self._leaf_specs().items():
            # unwritten int8 rows dequantize to 0 * 1.0
            fill = torch.ones if name.endswith("_scale") else torch.zeros
            layers[name] = fill(shape, dtype=dtype, device=self.device)
        return dict(pos=torch.zeros((), dtype=torch.int32,
                                    device=self.device), layers=layers)

    def page_bytes(self) -> int:
        """Bytes one pool page costs across every paged leaf, scale siblings
        included."""
        total = 0
        for shape, dtype in self._leaf_specs().values():
            n = int(np.prod(shape)) // self.num_pages
            total += n * torch.empty((), dtype=dtype).element_size()
        return total

    # ------------------------------------------------------------ bookkeeping
    @property
    def tables(self) -> np.ndarray:
        """(num_slots, pages_per_slot) int32 host page table. Entries past a
        slot's reserved count are 0 (the scratch page). Read-only."""
        return self._tables

    @property
    def free_page_count(self) -> int:
        return len(self._free_pages)

    def live_page_count(self) -> int:
        return int(np.sum(self._ref[1:] > 0))

    def refcounts(self) -> np.ndarray:
        """(num_pages,) int32 page refcounts (page 0 holds 1: scratch)."""
        return self._ref

    def _take_free_page(self) -> int:
        if not self._free_pages:
            raise PageError("page pool exhausted")
        return heapq.heappop(self._free_pages)

    def _decref(self, page: int) -> None:
        self._ref[page] -= 1
        assert self._ref[page] >= 0, f"page {page} refcount underflow"
        if self._ref[page] == 0:
            heapq.heappush(self._free_pages, page)

    def reserve(self, slot: int, upto_len: int) -> None:
        """Grow ``slot``'s table to cover positions [0, min(upto_len,
        max_len)). Called before each k-step block so the table is constant
        within a block."""
        if slot not in self._owner:
            raise SlotError(f"slot {slot} is not allocated")
        need = -(-min(int(upto_len), self.max_len) // self.page_size)
        n = int(self._n_pages[slot])
        while n < need:
            pg = self._take_free_page()
            self._ref[pg] += 1
            self._tables[slot, n] = pg
            n += 1
        self._n_pages[slot] = n

    def free(self, slot: int) -> None:
        if slot not in self._owner:
            raise SlotError(f"slot {slot} is not allocated")
        for i in range(int(self._n_pages[slot])):
            self._decref(int(self._tables[slot, i]))
        # stale frozen-slot writes (and any read) now divert to scratch
        self._tables[slot, :] = 0
        self._n_pages[slot] = 0
        super().free(slot)

    # ----------------------------------------------------------- page defrag
    def page_fragmentation(self) -> float:
        """Hole fraction of the occupied page span [1, max live page]."""
        live = np.flatnonzero(self._ref[1:] > 0) + 1
        if live.size == 0:
            return 0.0
        return 1.0 - live.size / int(live.max())

    def defrag_pages(self, cache: dict) -> dict:
        """Compact live pages to the front of the pool, in place.

        A permutation along every page axis; tables and refcounts are
        remapped through the same lookup table, so slot contents are
        unchanged."""
        live = [0] + [int(p) for p in np.flatnonzero(self._ref[1:] > 0) + 1]
        dead = [p for p in range(self.num_pages) if self._ref[p] == 0]
        perm = np.asarray(live + dead, np.int64)
        if np.array_equal(perm, np.arange(self.num_pages)):
            return cache
        lut = np.empty((self.num_pages,), np.int32)
        lut[perm] = np.arange(self.num_pages, dtype=np.int32)
        perm_dev = to_device(perm, self.device)

        def f(leaf, pax):
            if pax != _NO_BATCH:
                leaf.copy_(leaf.index_select(pax, perm_dev))
            return leaf

        cache = tree_map(f, cache, self.page_axes)
        self._ref = self._ref[perm]
        self._tables = lut[self._tables]      # freed rows are 0 -> stay 0
        self._free_pages = list(range(len(live), self.num_pages))
        return cache

    def defrag(self, cache: dict):
        """Slot-row defrag (inherited) + page-table row permutation."""
        cache, perm, mapping = super().defrag(cache)
        hp = np.asarray(perm)
        self._tables = self._tables[hp]
        self._n_pages = self._n_pages[hp]
        return cache, perm, mapping

"""Paged KV cache pool + radix-style shared-prefix reuse (the counterpart of
``repro.serve.paging``).

``PagedCachePool`` scales :class:`repro_torch.serve.cache.CachePool` from
whole-row slots to sub-slot *pages*: every attention K/V leaf trades its
``(..., num_slots, max_len, ...)`` row layout for a flat page pool
``(..., num_pages, page_size, ...)`` plus a host-side per-slot page table
``(num_slots, pages_per_slot) int32``. A slot's logical position ``p``
lives at pool page ``table[slot, p // page_size]``, row ``p % page_size``:
the decode block scatters new K/V through the table and the
``paged_attention`` op reads through it, so cache capacity is however many
pages are actually written.

Which leaves get paged is *inferred*, like the batch axes: the pool builds
``init_cache`` on the ``meta`` device at two ``max_len`` values and diffs
the shapes. A leaf whose sequence axis sits right after its batch axis is a
K/V page leaf (every attention family's layers, deepseek's ``dense0``,
zamba2's shared-attention K/V, whisper's self-attention); everything else —
the mamba2 conv/ssm state, whisper's ``enc_len``-sized cross K/V, the
scalar ``pos`` — keeps the slot layout and the inherited slot ops (the
paged leaves are masked out of ``batch_axes``). A pure SSM has no paged
leaf (``has_paged`` is false) and the engine keeps the slot pool.

Page 0 is a reserved scratch page: freeing a slot zeroes its table row on
the host, so the stale writes a finished slot keeps issuing inside a k-step
block divert into page 0, and reads never see it because every read is
masked by ``kv_valid``. Retiring a request is a host-only table edit.

Shared-prefix reuse (``PrefixCache``) is a radix trie keyed by
``page_size``-token prompt chunks. At admission a prompt walks the trie;
every fully matched chunk maps the node's page *read-only* into the new
slot's table (refcount bump, prefill for those tokens skipped), and a
partial last-chunk match copies the divergence page (copy-on-write) so the
new request extends it privately. Pages are refcounted across slot tables
and trie nodes; a page returns to the free heap when its count reaches
zero, and the trie evicts least-recently-matched leaves when the pool runs
dry, then raises. ``defrag_pages`` compacts live pages to the front of the
pool by a permutation, remapping tables, refcounts and trie pointers
through the same lookup table.

Quantized pages (``kv_dtype="int8"``): the paged K/V leaves store int8
codes with float32 scale siblings ``k_scale``/``v_scale`` (the leaf minus
its head_dim axis), one scale per page row and KV head (symmetric absmax
over head_dim). Quantization happens on scatter (``models.blocks``) and
both ``paged_attention`` impls dequantize on read; the scale leaves ride
the same page tables, copies and defrags. An int8 page plus its scales
costs about half the bytes of the bf16 page, so the default ``num_pages``
doubles. ``kv_dtype="f32"`` keeps the ``init_cache`` dtypes (bf16 K/V).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import to_device
from repro_torch.serve.cache import (CachePool, SlotError, _NO_BATCH,
                                     compact, local_zeros, meta_cache,
                                     tree_leaves, tree_map)


class PageError(RuntimeError):
    """Page pool exhausted (or invalid page transition)."""


def _page_axes(cfg, max_len: int, enc_len: Optional[int],
               batch_axes: dict) -> dict:
    """Tree of sequence-axis indices for pageable leaves.

    A leaf is pageable iff varying ``max_len`` (``enc_len`` pinned) moves
    exactly one axis *and* that axis sits right after the leaf's batch axis
    — the ``(..., B, seq, heads, head_dim)`` K/V layout of every attention
    family. ``_NO_BATCH`` for leaves that stay in slot layout.
    """
    a = meta_cache(cfg, 2, max_len, enc_len)
    b = meta_cache(cfg, 2, max_len + 1, enc_len)

    def diff(x, y, bax):
        axes = [i for i, (p, q) in enumerate(zip(x.shape, y.shape)) if p != q]
        if len(axes) != 1 or bax == _NO_BATCH:
            return _NO_BATCH
        return axes[0] if axes[0] == bax + 1 else _NO_BATCH

    return tree_map(diff, a, b, batch_axes)


def _with_scale_siblings(tree: dict, axes: dict, fn) -> dict:
    """Rebuild nested dicts ``tree``, giving paged K/V leaves a
    ``<name>_scale`` sibling: ``fn(name, leaf, ax) -> (new_leaf,
    scale_or_None)``; ``axes`` is a same-structure tree (the base page
    axes)."""
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, dict):
            out[name] = _with_scale_siblings(sub, axes[name], fn)
            continue
        leaf, scale = fn(name, sub, axes[name])
        out[name] = leaf
        if scale is not None:
            out[name + "_scale"] = scale
    return out


class _TrieNode:
    __slots__ = ("chunk", "page", "children", "parent", "tick")

    def __init__(self, chunk, page, parent):
        self.chunk = chunk          # tuple of page_size token ids (None: root)
        self.page = page            # pool page index holding this chunk's K/V
        self.children: Dict[tuple, "_TrieNode"] = {}
        self.parent = parent
        self.tick = 0


class PrefixCache:
    """Radix trie over ``page_size``-token prompt chunks -> shared pages.

    Host-only bookkeeping: the trie stores page *indices*; the K/V bytes
    live in the pool. Each node holds one refcount on its page (taken at
    insert, released at eviction), so a page stays alive while any trie
    node or slot table points at it.
    """

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self.root = _TrieNode(None, None, None)
        self.n_nodes = 0
        self._tick = 0

    def _touch(self, node: _TrieNode) -> None:
        self._tick += 1
        node.tick = self._tick

    def _chunks(self, prompt: Sequence[int]) -> List[tuple]:
        P = self.page_size
        return [tuple(prompt[i * P:(i + 1) * P])
                for i in range(len(prompt) // P)]

    def match(self, prompt: Sequence[int]
              ) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """-> (full_pages, partial). ``full_pages`` are pool pages for the
        longest run of whole prompt chunks present in the trie; ``partial``
        is ``(page, lcp_len)`` for the best divergent-chunk match (the
        copy-on-write source), or None."""
        P = self.page_size
        node = self.root
        pages: List[int] = []
        depth = 0
        for ch in self._chunks(prompt):
            child = node.children.get(ch)
            if child is None:
                break
            node = child
            self._touch(node)
            pages.append(node.page)
            depth += 1
        rem = tuple(prompt[depth * P:(depth + 1) * P])
        best: Optional[Tuple[int, int]] = None
        best_node: Optional[_TrieNode] = None
        if rem:
            for ch, child in node.children.items():
                n = 0
                for x, y in zip(ch, rem):
                    if x != y:
                        break
                    n += 1
                if n and (best is None or n > best[1]):
                    best = (child.page, n)
                    best_node = child
            # touch only the winning candidate: refreshing every scanned
            # runner-up would keep cold losing branches "recent"
            if best_node is not None:
                self._touch(best_node)
        return pages, best

    def insert_path(self, chunks: Sequence[tuple],
                    pages: Sequence[int]) -> List[int]:
        """Walk/extend the trie along ``chunks``; returns the page indices
        newly inserted (the caller bumps their refcounts). Existing nodes
        are kept: their pages hold identical K/V by construction."""
        node = self.root
        added: List[int] = []
        for ch, pg in zip(chunks, pages):
            child = node.children.get(ch)
            if child is None:
                child = _TrieNode(ch, int(pg), node)
                node.children[ch] = child
                self.n_nodes += 1
                added.append(int(pg))
            node = child
            self._touch(node)
        return added

    def iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def evict_lru(self, evictable=None) -> Optional[int]:
        """Drop the least-recently-matched *leaf*; returns its page (the
        caller decrements its refcount), or None when no leaf qualifies.
        ``evictable``: optional page predicate; leaves whose page fails it
        (one a slot table still maps: dropping it frees nothing) are
        skipped."""
        leaf = None
        for node in self.iter_nodes():
            if node.children or \
                    (evictable is not None and not evictable(node.page)):
                continue
            if leaf is None or node.tick < leaf.tick:
                leaf = node
        if leaf is None:
            return None
        del leaf.parent.children[leaf.chunk]
        self.n_nodes -= 1
        return leaf.page

    def remap(self, lut: np.ndarray) -> None:
        """Rewrite node pages through a defrag LUT (old page -> new page)."""
        for node in self.iter_nodes():
            node.page = int(lut[node.page])


class PagedCachePool(CachePool):
    """CachePool whose attention K/V leaves live in a shared page pool.

    Slot bookkeeping (allocate/free/owner/keys/row-defrag) is inherited;
    the paged leaves are taken out of ``batch_axes`` so every inherited
    slot op skips them, and this class adds the page-table layer on top.
    """

    def __init__(self, cfg, num_slots: int, max_len: int, *,
                 page_size: int, enc_len: Optional[int] = None,
                 num_pages: Optional[int] = None, kv_dtype: str = "f32",
                 device=None, rules=None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if kv_dtype not in ("f32", "int8"):
            raise ValueError(
                f"kv_dtype must be 'f32' or 'int8', got {kv_dtype!r}")
        if getattr(cfg, "family", None) == "audio" and enc_len is None:
            enc_len = max_len      # pin enc_len so the max_len diff is clean
        super().__init__(cfg, num_slots, max_len, enc_len=enc_len,
                         device=device, rules=rules)
        self.page_size = int(page_size)
        self.pages_per_slot = -(-self.max_len // self.page_size)   # ceil
        base_pax = _page_axes(cfg, self.max_len, self.enc_len,
                              self.batch_axes)
        self.has_paged = any(ax != _NO_BATCH for ax in tree_leaves(base_pax))
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == "int8" and self.has_paged
        # +1 for the reserved scratch page 0; the default backs every slot
        # to full depth, doubled for int8 pages (about half the bytes each)
        if num_pages is None:
            num_pages = 1 + self.num_slots * self.pages_per_slot * \
                (2 if self.quantized else 1)
        self.num_pages = int(num_pages)
        if self.num_pages < 2:
            raise ValueError("num_pages must cover scratch + one real page")
        # _base_page_axes matches the init_cache structure (no scale
        # leaves); page_axes/batch_axes match the pool cache, which in
        # quantized mode carries k_scale/v_scale siblings whose page axis
        # sits at the parent's index
        self._base_page_axes = base_pax
        self.page_axes = base_pax
        self.batch_axes = tree_map(
            lambda bax, pax: _NO_BATCH if pax != _NO_BATCH else bax,
            self.batch_axes, base_pax)
        if self.quantized:
            self.page_axes = _with_scale_siblings(
                base_pax, base_pax,
                lambda name, pax, _: (pax, pax if self._quant_leaf(name, pax)
                                      else None))
            self.batch_axes = _with_scale_siblings(
                self.batch_axes, base_pax,
                lambda name, bax, pax: (bax, _NO_BATCH
                                        if self._quant_leaf(name, pax)
                                        else None))
        self._tables = np.zeros((self.num_slots, self.pages_per_slot),
                                np.int32)
        self._n_pages = np.zeros((self.num_slots,), np.int32)
        self._ref = np.zeros((self.num_pages,), np.int32)
        self._ref[0] = 1                      # scratch page is always live
        self._free_pages: List[int] = list(range(1, self.num_pages))
        self.prefix = PrefixCache(self.page_size)

    # ----------------------------------------------------------- construction
    @staticmethod
    def _quant_leaf(name, pax) -> bool:
        """Paged K/V value leaves quantize (and grow a scale sibling);
        whisper's cross K/V keep slot layout and are excluded with the
        recurrent state."""
        return pax != _NO_BATCH and name in ("k", "v")

    def _pool_arrays(self, device) -> dict:
        """The pool cache on ``device`` — paged leaves in page-pool layout,
        int8 + float32 scale siblings when quantized; ``meta`` for shapes
        only; this rank's shard of every leaf under ``rules`` (a page's
        rows split over the model axis). Built from ``init_cache``'s shapes
        on the ``meta`` device (every leaf of it is zeros), so the
        slot-layout K/V is never allocated."""
        cache = meta_cache(self.cfg, self.num_slots, self.max_len,
                           self.enc_len)

        def zeros(name, shape, dtype, fill=0.0):
            return local_zeros(name, shape, dtype, self.rules, device, fill)

        def f(name, leaf, pax):
            if pax == _NO_BATCH:
                return zeros(name, leaf.shape, leaf.dtype), None
            shp = (tuple(leaf.shape[:pax - 1])
                   + (self.num_pages, self.page_size)
                   + tuple(leaf.shape[pax + 1:]))
            if not self.quantized or not self._quant_leaf(name, pax):
                return zeros(name, shp, leaf.dtype), None
            # scale = parent minus the trailing head_dim axis; unwritten
            # rows dequantize to 0 * 1.0
            return (zeros(name, shp, torch.int8),
                    zeros(name + "_scale", shp[:-1], torch.float32, 1.0))

        return _with_scale_siblings(cache, self._base_page_axes, f)

    def make_cache(self) -> dict:
        return self._pool_arrays(self.device)

    def page_bytes(self) -> int:
        """Bytes one pool page costs across every paged leaf, scale siblings
        included (this rank's rows of it under ``rules``)."""
        shapes = self._pool_arrays("meta")
        total = 0
        for leaf, pax in zip(tree_leaves(shapes),
                             tree_leaves(self.page_axes)):
            if pax == _NO_BATCH:
                continue
            n = int(np.prod(leaf.shape)) // leaf.shape[pax - 1]
            total += n * leaf.element_size()
        return total

    def set_slot(self, cache: dict, slot: int, row_cache: dict) -> dict:
        # the batch=1 row cache comes from init_cache and has no scale
        # leaves; pad its structure with dummies (their batch_axes entries
        # are _NO_BATCH, so the inherited write skips them)
        if self.quantized:
            row_cache = _with_scale_siblings(
                row_cache, self._base_page_axes,
                lambda name, leaf, pax: (leaf, torch.zeros(())
                                         if self._quant_leaf(name, pax)
                                         else None))
        return super().set_slot(cache, slot, row_cache)

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
        while True:
            if self._free_pages:
                return heapq.heappop(self._free_pages)
            # only leaves the trie *solely* owns (refcount == the trie's
            # single reference) can yield a free page; evicting a slot-held
            # leaf frees nothing and would only destroy future prefix hits
            pg = self.prefix.evict_lru(evictable=lambda p: self._ref[p] <= 1)
            if pg is None:
                raise PageError("page pool exhausted")
            self._decref(pg)

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

    # -------------------------------------------------------- prefix sharing
    def map_prefix(self, slot: int, prompt: Sequence[int]
                   ) -> Tuple[int, Optional[Tuple[int, int]]]:
        """Map trie-shared prompt-prefix pages into ``slot``'s table.

        Returns ``(m, cow)``: ``m`` prompt tokens whose K/V is already in
        the mapped pages (their prefill is skipped: the slot starts at
        ``lengths == m``), and ``cow = (src, dst)`` when the last matched
        chunk was partial: the caller copies page ``src`` into the freshly
        allocated ``dst`` (:meth:`copy_page`) before decoding. The match is
        capped at ``len(prompt) - 1`` so the final prompt token is always
        consumed in-loop (it primes the first emission).
        """
        if slot not in self._owner:
            raise SlotError(f"slot {slot} is not allocated")
        if int(self._n_pages[slot]):
            raise PageError(f"slot {slot} already holds pages")
        full, partial = self.prefix.match(prompt)
        P = self.page_size
        m = len(full) * P + (partial[1] if partial else 0)
        m = min(m, len(prompt) - 1, self.max_len - 1)
        if m <= 0:
            return 0, None
        n_full, part = divmod(m, P)
        cow = None
        for i in range(n_full):
            pg = full[i]
            self._ref[pg] += 1
            self._tables[slot, i] = pg
        if part:
            src = full[n_full] if n_full < len(full) else partial[0]
            dst = self._take_free_page()
            self._ref[dst] += 1
            self._tables[slot, n_full] = dst
            cow = (src, dst)
        self._n_pages[slot] = n_full + (1 if part else 0)
        return m, cow

    def register_prefix(self, slot: int, prompt: Sequence[int],
                        written_len: int) -> int:
        """Publish ``slot``'s fully written whole-prompt pages to the trie.

        Idempotent: existing trie nodes are descended through, not
        replaced. Only pages entirely inside the prompt *and* entirely
        written (``written_len`` tokens consumed) are published. Returns
        the number of pages newly inserted."""
        if slot not in self._owner:
            raise SlotError(f"slot {slot} is not allocated")
        P = self.page_size
        limit = min(min(int(written_len), len(prompt)) // P,
                    int(self._n_pages[slot]))
        if limit <= 0:
            return 0
        chunks = self.prefix._chunks(prompt)[:limit]
        pages = [int(self._tables[slot, i]) for i in range(limit)]
        added = self.prefix.insert_path(chunks, pages)
        for pg in added:
            self._ref[pg] += 1                # the trie's own reference
        return len(added)

    # --------------------------------------------------------- n>1 fan-out
    def adopt_prompt_pages(self, src_slot: int, dst_slot: int,
                           n_tok: int) -> int:
        """Share ``src_slot``'s whole-prompt pages into ``dst_slot``'s table.

        Fan-out admission: the n streams of one request prefill the same
        prompt in lockstep, so every page entirely inside the prompt holds
        identical K/V whichever stream writes it; the siblings map the
        *same* refcounted pages and only the boundary page stays private.
        Returns the number of shared pages.
        """
        for s in (src_slot, dst_slot):
            if s not in self._owner:
                raise SlotError(f"slot {s} is not allocated")
        if int(self._n_pages[dst_slot]):
            raise PageError(f"slot {dst_slot} already holds pages")
        n_shared = min(int(n_tok) // self.page_size,
                       int(self._n_pages[src_slot]))
        for i in range(n_shared):
            pg = int(self._tables[src_slot, i])
            self._ref[pg] += 1
            self._tables[dst_slot, i] = pg
        self._n_pages[dst_slot] = n_shared
        return n_shared

    def map_cow_page(self, slot: int, index: int) -> int:
        """Allocate a fresh private page at ``table[slot, index]`` (the
        fan-out boundary-page copy-on-write destination). Returns the new
        page; the caller owns the :meth:`copy_page` into it."""
        if slot not in self._owner:
            raise SlotError(f"slot {slot} is not allocated")
        if int(self._n_pages[slot]) != index:
            raise PageError(
                f"slot {slot}: cow index {index} != next page "
                f"{int(self._n_pages[slot])}")
        dst = self._take_free_page()
        self._ref[dst] += 1
        self._tables[slot, index] = dst
        self._n_pages[slot] = index + 1
        return dst

    def pin_page(self, page: int) -> None:
        """Extra refcount hold: keeps a copy-on-write source page off the
        eviction path while a fan-out admission still issues sibling
        copies."""
        self._ref[page] += 1

    def unpin_page(self, page: int) -> None:
        self._decref(page)

    def copy_page(self, cache: dict, src: int, dst: int) -> dict:
        """Copy pool page ``src`` into ``dst`` in every paged leaf, in place
        on the device (copy-on-write)."""
        def f(leaf, pax):
            if pax != _NO_BATCH:
                ax = pax - 1                  # page axis replaced batch axis
                leaf.select(ax, dst).copy_(leaf.select(ax, src))
            return leaf
        return tree_map(f, cache, self.page_axes)

    # ----------------------------------------------------------- page defrag
    def page_fragmentation(self) -> float:
        """Hole fraction of the occupied page span [1, max live page]."""
        live = np.flatnonzero(self._ref[1:] > 0) + 1
        if live.size == 0:
            return 0.0
        return 1.0 - live.size / int(live.max())

    def defrag_pages(self, cache: dict) -> dict:
        """Compact live pages to the front of the pool, in place.

        A permutation along every page axis (the live pages moved by
        :func:`serve.cache.compact`); tables, refcounts and trie pointers
        are remapped through the same lookup table, so slot contents (and
        the emission-count PRNG streams) are unchanged."""
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
                compact(leaf, pax - 1, perm_dev, len(live))
            return leaf

        cache = tree_map(f, cache, self.page_axes)
        self._ref = self._ref[perm]
        self._tables = lut[self._tables]      # freed rows are 0 -> stay 0
        self.prefix.remap(lut)
        self._free_pages = list(range(len(live), self.num_pages))
        return cache

    def defrag(self, cache: dict):
        """Slot-row defrag (inherited) + page-table row permutation."""
        cache, perm, mapping = super().defrag(cache)
        hp = np.asarray(perm)
        self._tables = self._tables[hp]
        self._n_pages = self._n_pages[hp]
        return cache, perm, mapping

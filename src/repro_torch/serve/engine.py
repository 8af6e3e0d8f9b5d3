"""Continuous-batching engine: ingest queue -> schedule -> k-step decode ->
retire slots -> stats (the counterpart of ``repro.serve.engine``).

One ``step()`` is one scheduling round plus one k-step block: admit queued
requests into free cache slots (their prompts go into the host prompt
buffer, reused slot rows are zeroed, whisper's cross K/V is prefilled from
the request's frame embeddings), copy the block's host inputs to the card,
run the block, then make the round's single host sync — one wait for the
block's packed outputs (the k emitted tokens, the per-slot done masks and
lengths) — extend per-request outputs, and retire finished slots. Every
shape (num_slots, max_prompt, k) is fixed at construction. Every family
of the port is served: the slot pool holds whatever ``init_cache`` holds
(recurrent state, cross K/V), the paged pool pages the attention K/V.

Sampling (``Request.sampling``) changes none of that: per-slot temperature
/ top-p / top-k and the request PRNG key are slot-row state written at
admission, and all k draws happen inside the block
(``repro_torch.serve.sampling``): the sync count with sampling on equals
greedy's. A batch that is all greedy (read from the host's own copy of the
policy) runs the block without the sampler.

Streaming: ``stream_step`` also returns per-request token deltas for the
round (``StreamDelta``), and ``stream`` is the generator form.

Fan-out (``Request.n > 1``): the n streams of a request are admitted
atomically, share the prompt's whole pages (refcount, no copy) and draw
from ``host_fold_in(request_key, i)``; stream i is bit-identical to a
standalone request seeded ``fold_in_seed(seed, i)``.

The prefix cache (``prefix_cache=True``, paged pools of the dense, vlm and
moe families): admission maps trie-shared prompt pages into the new slot
and skips their prefill, copying a partially matched page
(copy-on-write); completed prompt pages are published to the trie.

Double-buffering (``overlap=True``): the k-step schedule cut the sync
*count* to one per k steps; the overlapped loop hides the one left. Each
round launches block i+1 *before* waiting for block i's outputs, on a
one-deep pipeline of :class:`_InFlight` records. A block's outputs are
packed on the card and copied without blocking into pinned host memory
behind a CUDA event, so waiting for block i is one ``Event.synchronize``
while block i+1 is already queued; all host work of a round (admission,
prompt staging, stream deltas, scheduler and defrag bookkeeping) overlaps
the newer block. Correctness rests on stale-slot fencing: a slot retired
while a newer block is in flight is *fenced* — its row, pages and PRNG key
are released only when that block lands, so admission can never hand the
row to a new request the in-flight block still writes. Slot and page
defrag flush the pipeline first. Each block's host inputs (prompt buffer,
lengths, sampling policy, page table) are snapshotted at launch into
pinned buffers of their own (``repro_torch.to_device``), so the host may
rewrite its arrays while a copy is still in flight; admission's device
writes run on the same stream, after the in-flight block. Token streams
are bit-identical to the blocking engine's.

Sharded serving (``rules=``, the JAX engine's): on a mesh (1, m) the dense
family serves tensor-parallel over the model axis. The weights become
this rank's shards at construction (``launch.steps.serve_params``), the
pool holds the rank's rows of every slot or page (JAX's ``cache_specs``),
and the block merges the ranks' attention partials
(``launch.steps.make_serve_step``). Every rank runs this host loop on the
same requests: page tables, the allocator, the prefix trie and its
copy-on-write, fan-out and the scheduler decide the same on every rank,
the seed drawn for a seedless sampled request is rank 0's, and every rank
draws the same tokens, so each returns the same responses. The other
families on a model axis past 1 raise (ROADMAP queue 1 item 7(a)), as
does a data axis past 1 (pages and slots over the data ranks need a
scheduler across them, item 7(d)) and a deadline gate on a model group (a
rank's own clock would shed its own way, item 7(d)).

Observability (``repro_torch.obs``): the JAX engine's counters and
histograms under its names, the ``serve.admit`` span and instant, the
``serve.decode_block`` spans around the block and around its fetch, the
``serve.retire`` instant, and ``mark_dispatch("serve.decode_block")``
before each block with ``mark_fetch(ticket)`` before its wait, so a sync
audit counts one round trip per block (equal to ``EngineStats.syncs``) and
the fetches made with a newer block in flight as hidden
(``EngineStats.hidden_syncs``). Each round's mutations sit behind one
``obs.enabled()`` check.
"""
from __future__ import annotations

import time
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import Unsupported, obs, resolve_device, to_device
from repro_torch.core.distributed import CollectiveCount
from repro_torch.launch.steps import serve_params
from repro_torch.models import init_cache, prefill_audio_cache, tp
from repro_torch.models.transformer import slot_rows
from repro_torch.serve.api import (Request, Response, EngineStats, StreamDelta,
                                   FINISH_EOS, FINISH_ERROR, FINISH_LENGTH,
                                   FINISH_SHED)
from repro_torch.serve.cache import CachePool
from repro_torch.serve.decode import init_decode_state, make_decode_block
from repro_torch.serve.paging import PagedCachePool
from repro_torch.serve.sampling import GREEDY, SlotSampling, host_fold_in
from repro_torch.serve.scheduler import Scheduler

# ---------------------------------------------------------------------------
# observability handles (module-level: get-or-create once, mutate per round;
# every mutation is a no-op boolean check while repro_torch.obs is disabled)
# ---------------------------------------------------------------------------
_M_SYNCS = obs.counter("repro_serve_syncs_total",
                       "host<->device round trips (one per fused k-block)")
_M_STEPS = obs.counter("repro_serve_steps_total",
                       "model decode steps (= syncs * k)")
_M_TOKENS = obs.counter("repro_serve_tokens_total",
                        "tokens delivered to responses")
_M_PREFILL = obs.counter("repro_serve_prefill_tokens_total",
                         "prompt tokens consumed in-loop")
_M_REQS = obs.counter("repro_serve_requests_total",
                      "completed requests by finish reason")
_M_PREFIX_HITS = obs.counter("repro_serve_prefix_hits_total",
                             "admissions that matched the prefix trie")
_M_PREFIX_TOKENS = obs.counter("repro_serve_prefix_tokens_total",
                               "prefill tokens skipped via prefix reuse")
_M_COW = obs.counter("repro_serve_cow_copies_total",
                     "copy-on-write page divergences")
_M_DEFRAGS = obs.counter("repro_serve_defrags_total",
                         "cache compactions by kind (slot/page)")
_M_TTFT = obs.histogram("repro_serve_ttft_seconds",
                        "submit -> first generated token")
_M_TPOT = obs.histogram("repro_serve_tpot_seconds",
                        "mean per-token latency after the first token")
_M_QWAIT = obs.histogram("repro_serve_queue_wait_seconds",
                         "submit -> slot assignment")
_M_LATENCY = obs.histogram("repro_serve_latency_seconds",
                           "submit -> retirement")
_M_HIDDEN = obs.counter("repro_serve_hidden_syncs_total",
                        "k-block fetches made while a newer block was "
                        "already in flight (double-buffered loop)")
_M_BLOCKED = obs.histogram("repro_serve_host_blocked_seconds",
                           "host wall time blocked per k-block result fetch")


class _InFlight:
    """One launched-but-not-fetched k-block (the pipeline entry).

    ``packed`` holds the block's outputs (tokens, emit mask, done and eos
    masks, lengths) as one int32 tensor, computed on the stream right after
    the block, before any later admission writes the state in place; on a
    card ``host`` is its pinned copy and ``event`` marks the copy's end.
    ``slots``/``active`` snapshot the slot ownership at launch: completion
    only touches rows this block owned, and ``deferred`` collects slots
    retired while the block was in flight — their pool rows stay fenced
    (allocated, unreusable) until it lands.
    """

    __slots__ = ("packed", "host", "event", "slots", "active", "live",
                 "ticket", "deferred")

    def __init__(self, packed, host, event, slots, active, live, ticket):
        self.packed = packed            # (2kB + 3B,) int32 on the device
        self.host = host                # its pinned host copy (card only)
        self.event = event              # recorded after the copy (card only)
        self.slots = slots              # slot ids owned at launch
        self.active = active            # (B,) host bool snapshot at launch
        self.live = live                # active slot count at launch
        self.ticket = ticket            # obs.mark_dispatch ticket
        self.deferred: List[int] = []   # retired slots fenced on this block


class Engine:
    """Continuous-batching serving engine over a slot or paged pool.

    params/cfg: model weights + arch config (any of the ten). device: where
    the cache lives and the block runs; ``cuda`` unless the caller asks for
    another (raises with no card). num_slots: concurrent sequences (the
    block's batch dimension). max_len: per-slot cache depth; k: decode
    steps per host sync. eos_id: stop a slot on this token (None:
    length-only). scheduler: admission policy; default plain FIFO (pass
    ``Scheduler(gate=DeadlineGate(...))`` for overload shedding). enc_len:
    whisper's encoder length (default max_len); its requests carry
    ``enc_embeds`` of shape (enc_len, d_model).
    page_size: put the attention K/V leaves in a paged pool with this many
    tokens per page; None keeps the whole-row slot layout, read as pages of
    ``models.transformer.SLOT_PAGE`` (16) rows. Token streams are identical
    either way on the CPU; on the card, where the pages are read by the
    ``paged_decode`` kernel, at a page_size of 16. A pure-SSM arch has no pageable leaves and
    keeps the slot pool. num_pages: page-pool depth override. kv_dtype:
    ``"f32"`` keeps the init_cache dtypes (bf16 K/V); ``"int8"`` (paged
    pools only) stores int8 codes with per-(page row, head) float32 scales.
    prefix_cache: with paging on, reuse radix-trie shared prompt-prefix
    pages across requests (their prefill steps are skipped); on only for
    families whose prompt K/V depends on the tokens alone (dense, vlm,
    moe): recurrent state must consume every prompt token, and whisper's
    decoder K/V mixes in per-request encoder output.
    overlap: double-buffer the host loop (module docstring); token streams
    are bit-identical either way; ``stats.hidden_syncs`` /
    ``stats.host_blocked_s`` report the effect. sync_debug: run each block
    under ``torch.cuda.set_sync_debug_mode("error")`` so a hidden host sync
    in it raises (a card only).

    rules: ``dist.sharding.make_rules(mesh, group)`` to serve on a mesh
    (the module docstring); ``params`` are then the whole tree (each rank
    keeps its shards only) or this rank's shards already
    (``launch.steps.serve_params``). ``collectives`` counts the merge's
    gathers of the model axis.

    ``Request.n > 1`` fans a request into n slots (see the module
    docstring); each stream finishes with its own ``Response``.
    """

    def __init__(self, params, cfg, *, num_slots: int = 8,
                 max_len: int = 128, k: int = 4,
                 max_prompt: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 scheduler: Optional[Scheduler] = None,
                 enc_len: Optional[int] = None,
                 defrag_threshold: float = 0.5,
                 page_size: Optional[int] = None,
                 prefix_cache: bool = False,
                 num_pages: Optional[int] = None,
                 kv_dtype: str = "f32",
                 overlap: bool = False,
                 device=None, sync_debug: bool = False, rules=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        tp_size = 1
        if rules is not None:
            tp_size = rules.tp_size
            if rules.dp_size > 1:
                raise Unsupported(
                    f"{cfg.name}: the engine on a data axis of "
                    f"{rules.dp_size}: pages and slots over the data ranks "
                    f"need a scheduler across them (ROADMAP queue 1 item "
                    f"7(d))")
            if tp_size > 1 and scheduler is not None and \
                    scheduler.gate is not None:
                raise Unsupported(
                    "a deadline gate on a model group: each rank would "
                    "shed by its own clock (ROADMAP queue 1 item 7(d))")
        self.rules = rules if tp_size > 1 else None
        if self.rules is not None and not tp.is_tp(params["embed"]):
            params = serve_params(cfg, params, rules)
        self.params = params
        self.k = int(k)
        self.max_len = int(max_len)
        self.max_prompt = int(max_prompt if max_prompt is not None
                              else max_len)
        self.eos_id = eos_id
        enc_len = (enc_len if enc_len is not None else max_len) \
            if cfg.family == "audio" else None
        if kv_dtype != "f32" and page_size is None:
            raise ValueError("kv_dtype requires a paged pool: pass page_size")
        pool: Optional[CachePool] = None
        if page_size is not None:
            pool = PagedCachePool(cfg, num_slots, max_len,
                                  page_size=page_size, enc_len=enc_len,
                                  num_pages=num_pages, kv_dtype=kv_dtype,
                                  device=self.device, rules=self.rules)
            if not pool.has_paged:
                pool = None                 # pure SSM: nothing to page
        if pool is None:
            pool = CachePool(cfg, num_slots, max_len, enc_len=enc_len,
                             device=self.device, rules=self.rules)
        self.pool = pool
        self.paged = isinstance(pool, PagedCachePool)
        self.prefix_on = (bool(prefix_cache) and self.paged
                          and cfg.family in ("dense", "vlm", "moe"))
        self.scheduler = scheduler if scheduler is not None else Scheduler()
        self.defrag_threshold = float(defrag_threshold)
        self.overlap = bool(overlap)
        self._pipe: List[_InFlight] = []    # one-deep launch pipeline
        self.collectives = CollectiveCount()
        self._block = make_decode_block(
            cfg, k=self.k, max_len=self.max_len, eos_id=eos_id,
            sync_debug=sync_debug and self.device.type == "cuda",
            rules=self.rules,
            kv_rows=pool.page_size if self.paged else pool.rows,
            counter=self.collectives)
        self.state = init_decode_state(self.pool.make_cache(), num_slots,
                                       self.device)
        B, P = num_slots, self.max_prompt
        self._prompt_buf = np.zeros((B, P), np.int32)
        self._prompt_len = np.zeros((B,), np.int32)
        self._len_host = np.zeros((B,), np.int32)   # host mirror of lengths
        self._max_new = np.ones((B,), np.int32)
        self._active = np.zeros((B,), bool)
        # per-slot sampling policy (written at admission; keys live in the
        # pool so they follow the request through defrag)
        self._temp = np.zeros((B,), np.float32)
        self._top_p = np.ones((B,), np.float32)
        self._top_k = np.zeros((B,), np.int32)
        # for seedless requests: rank 0's seed on every rank of a group
        self._seed_rng = np.random.RandomState(self._group_seed())
        self._slot_req: dict = {}
        self._slot_toks: dict = {}
        self._slot_t0: dict = {}
        self._slot_prompt: dict = {}    # int token lists for the prefix trie
        self._slot_first: dict = {}     # slot -> TTFT (recorded with obs on)
        self._slot_stream: dict = {}    # fan-out stream index per slot
        self._groups: dict = {}         # request id -> unfinished streams
        self.stats = EngineStats()

    def _group_seed(self) -> Optional[int]:
        """None (fresh entropy) on one device; on a model group, a seed
        rank 0 draws, broadcast once over the group."""
        if self.rules is None:
            return None
        import torch.distributed as dist
        seed = torch.tensor([np.random.randint(0, 2 ** 31 - 1)],
                            dtype=torch.int64, device=self.device)
        dist.broadcast(seed, group_src=0, group=self.rules.group)
        return int(seed.item())

    # -------------------------------------------------------------- ingest
    def submit(self, req: Request) -> None:
        """Enqueue a request. Malformed requests (empty prompt, n < 1 or
        wider than the pool, whisper's missing or misshapen enc_embeds)
        raise at once; an over-long prompt is accepted here but rejected
        with a ``finish_reason="error"`` Response at admission."""
        if len(req.prompt) < 1:
            raise ValueError(f"request {req.id}: empty prompt")
        n_streams = int(req.n) if req.n is not None else 1
        if n_streams < 1:
            raise ValueError(f"request {req.id}: n must be >= 1, "
                             f"got {req.n}")
        if n_streams > self.pool.num_slots:
            # a group admits atomically (its streams prefill in lockstep to
            # share prompt pages): wider than the pool can never be placed
            raise ValueError(
                f"request {req.id}: n={n_streams} exceeds "
                f"num_slots={self.pool.num_slots}")
        if self.cfg.family == "audio":
            want = (self.pool.enc_len, self.cfg.d_model)
            got = np.shape(req.enc_embeds) if req.enc_embeds is not None \
                else None
            if got != want:
                raise ValueError(f"request {req.id}: enc-dec arch needs "
                                 f"enc_embeds of shape {want}, got {got}")
        self.scheduler.submit(req)

    # -------------------------------------------------------------- admit
    def _audio_row(self, enc_embeds) -> dict:
        """A batch=1 cache with whisper's cross K/V prefilled from one
        request's frame embeddings (enc_len, d_model)."""
        enc = to_device(np.asarray(enc_embeds, np.float32), self.device)
        row = init_cache(self.cfg, 1, slot_rows(self.max_len),
                         device=self.device, enc_len=self.pool.enc_len)
        return prefill_audio_cache(self.params, self.cfg, row,
                                   enc[None].to(torch.bfloat16))

    def _admit(self, now: float) -> List[Response]:
        out: List[Response] = []
        on = obs.enabled()
        admit, shed = self.scheduler.schedule(self.pool.free_count, now)
        for r in shed:
            wait = now - r.arrival_s
            out.append(Response(id=r.id, tokens=[], finish_reason=FINISH_SHED,
                                prompt_len=len(r.prompt), queue_wait_s=wait,
                                latency_s=wait))
            self.stats.shed += 1
            if on:
                _M_REQS.inc(reason=FINISH_SHED)
        cache = self.state.cache
        slots: List[int] = []
        init_lens: List[int] = []
        for r in admit:
            n = len(r.prompt)
            if n > self.max_prompt or n >= self.max_len:
                # an over-long prompt can never reach its first emit:
                # reject without a slot instead of spinning forever
                wait = now - r.arrival_s
                out.append(Response(
                    id=r.id, tokens=[], finish_reason=FINISH_ERROR,
                    prompt_len=n, queue_wait_s=wait, latency_s=wait))
                self.stats.rejected += 1
                if on:
                    _M_REQS.inc(reason=FINISH_ERROR)
                continue
            n_streams = int(r.n or 1)
            sp = r.sampling if r.sampling is not None else GREEDY
            base_key = None
            if not sp.greedy:
                seed = sp.seed if sp.seed is not None \
                    else int(self._seed_rng.randint(0, 2 ** 31 - 1))
                base_key = np.array([seed >> 32, seed & 0xFFFFFFFF],
                                    np.uint32)
            prompt = [int(t) for t in r.prompt]
            P = self.pool.page_size if self.paged else 0
            audio = self._audio_row(r.enc_embeds) \
                if self.cfg.family == "audio" else None
            group_slots: List[int] = []
            m0, cow, pinned = 0, None, False
            for i in range(n_streams):
                slot = self.pool.allocate(r.id)
                group_slots.append(slot)
                slots.append(slot)
                if audio is not None:
                    cache = self.pool.set_slot(cache, slot, audio)
                else:
                    cache = self.pool.zero_slot(cache, slot)
                if i == 0:
                    if self.prefix_on:
                        # trie-matched pages map read-only into this slot's
                        # table and their prefill steps vanish: the slot
                        # starts at lengths == m0
                        m0, cow = self.pool.map_prefix(slot, prompt)
                        if cow is not None:
                            cache = self.pool.copy_page(cache, *cow)
                            self.stats.cow_copies += 1
                            if on:
                                _M_COW.inc()
                        if m0:
                            self.stats.prefix_hits += 1
                            # every stream of the group starts at m0
                            self.stats.prefix_tokens += m0 * n_streams
                            if on:
                                _M_PREFIX_HITS.inc()
                                _M_PREFIX_TOKENS.inc(m0 * n_streams)
                    if n_streams > 1 and self.paged:
                        # reserve the whole-prompt page span up front so the
                        # siblings below adopt (refcount-share) it instead
                        # of allocating duplicate pages
                        self.pool.reserve(slot, (n // P) * P)
                        if cow is not None:
                            # keep the copy-on-write source off the LRU
                            # eviction path until every sibling's copy is
                            # issued
                            self.pool.pin_page(cow[0])
                            pinned = True
                elif self.paged:
                    self.stats.shared_prompt_pages += \
                        self.pool.adopt_prompt_pages(group_slots[0], slot, n)
                    if cow is not None and (m0 // P) >= (n // P):
                        # the trie match runs into the private boundary
                        # page: this sibling needs its own copy
                        dst = self.pool.map_cow_page(slot, n // P)
                        cache = self.pool.copy_page(cache, cow[0], dst)
                        self.stats.cow_copies += 1
                        if on:
                            _M_COW.inc()
                self._prompt_buf[slot, :] = 0
                self._prompt_buf[slot, :n] = np.asarray(r.prompt, np.int32)
                self._prompt_len[slot] = n
                self._len_host[slot] = m0
                init_lens.append(m0)
                self._slot_prompt[slot] = prompt
                self._max_new[slot] = max(int(r.max_new_tokens), 1)
                self._active[slot] = True
                self._temp[slot] = sp.temperature
                self._top_p[slot] = sp.top_p
                self._top_k[slot] = sp.top_k
                if base_key is not None:
                    # stream i draws from fold_in(request_key, i): derived
                    # on the host, and bit-identical to a standalone
                    # request seeded with fold_in_seed(seed, i)
                    self.pool.set_slot_key(
                        slot, base_key if n_streams == 1
                        else host_fold_in(base_key, i))
                self._slot_req[slot] = r
                self._slot_stream[slot] = i
                self._slot_toks[slot] = []
                self._slot_t0[slot] = now
                if on:
                    obs.instant("serve.admit", id=r.id, slot=slot,
                                prompt_len=n, prefix_reused=m0, stream=i)
            if pinned:
                self.pool.unpin_page(cow[0])
            self._groups[r.id] = n_streams
            self.stats.admitted += 1
            if n_streams > 1:
                self.stats.fanout_groups += 1
                self.stats.fanout_streams += n_streams
            if on:
                _M_QWAIT.observe(now - r.arrival_s)
        self.state.cache = cache
        if slots:
            # device writes with host values: index_fill_ takes a host
            # scalar and index_copy_ a tensor copied without blocking
            # (``t[idx] = 0`` would copy a CPU scalar tensor, a host sync)
            idx = to_device(np.asarray(slots, np.int64), self.device)
            st = self.state
            st.lengths.index_copy_(0, idx, to_device(
                np.asarray(init_lens, np.int32), self.device))
            for t in (st.last_tok, st.n_out):
                t.index_fill_(0, idx, 0)
            for t in (st.done, st.eos_hit):
                t.index_fill_(0, idx, False)
        return out

    # -------------------------------------------------------------- defrag
    def _needs_defrag(self) -> bool:
        """Threshold check only: the overlapped loop uses it to decide
        whether a pipeline flush is worth it. Fenced slots awaiting release
        still count as live; their frees land at the next completion, so a
        triggered defrag is at most one round late."""
        if self.pool.live_count and \
                self.pool.fragmentation() >= self.defrag_threshold:
            return True
        return self.paged and \
            self.pool.page_fragmentation() >= self.defrag_threshold

    def _maybe_defrag(self) -> None:
        # defrag permutes slot rows / page tables in place: the overlapped
        # loop flushes its pipeline first (no block may own moved rows)
        assert not self._pipe, "defrag with a block in flight"
        if self.pool.live_count and \
                self.pool.fragmentation() >= self.defrag_threshold:
            cache, perm, mapping = self.pool.defrag(self.state.cache)
            take = lambda a: self.pool.take_rows(a, perm)
            st = self.state
            st.cache = cache
            st.lengths, st.last_tok = take(st.lengths), take(st.last_tok)
            st.n_out, st.done = take(st.n_out), take(st.done)
            st.eos_hit = take(st.eos_hit)
            hperm = np.asarray(perm)
            for name in ("_prompt_buf", "_prompt_len", "_len_host",
                         "_max_new", "_active", "_temp", "_top_p", "_top_k"):
                setattr(self, name, getattr(self, name)[hperm])
            for name in ("_slot_req", "_slot_toks", "_slot_t0",
                         "_slot_prompt", "_slot_first", "_slot_stream"):
                setattr(self, name, {mapping[s]: v for s, v in
                                     getattr(self, name).items()})
            self.stats.defrags += 1
            if obs.enabled():
                _M_DEFRAGS.inc(kind="slot")
        if self.paged and \
                self.pool.page_fragmentation() >= self.defrag_threshold:
            # a page permutation: slot contents (and the emission-count
            # PRNG streams) are unchanged
            self.state.cache = self.pool.defrag_pages(self.state.cache)
            self.stats.page_defrags += 1
            if obs.enabled():
                _M_DEFRAGS.inc(kind="page")

    # ------------------------------------------------------ launch/fetch
    def _sampling(self) -> Optional[SlotSampling]:
        """The block's sampling inputs, or None when every slot is greedy
        (decided from the host's copy of the policy: no device read)."""
        if not (self._temp > 0.0).any():
            return None
        dev = self.device
        return SlotSampling(
            temperature=to_device(self._temp, dev),
            top_p=to_device(self._top_p, dev),
            top_k=to_device(self._top_k, dev),
            key=to_device(self.pool.slot_keys.astype(np.int64), dev))

    def _launch_block(self) -> _InFlight:
        """Copy the block's host inputs to the card, run the k-step block
        (it enqueues work and reads nothing back), and queue the copy of its
        packed outputs to the host."""
        live = int(self._active.sum())
        page_table = None
        if self.paged:
            # reserve pages for every position this block can write, so the
            # table is constant across its k steps; under overlap
            # ``_len_host`` is one unfetched block stale, so the horizon
            # covers the in-flight block's k steps too
            horizon = self.k * (2 if self.overlap else 1)
            for slot in self._slot_req:
                self.pool.reserve(slot, int(self._len_host[slot]) + horizon)
            page_table = to_device(self.pool.tables, self.device)
            self.stats.peak_live_pages = max(self.stats.peak_live_pages,
                                             self.pool.live_page_count())
        inputs = [to_device(a, self.device) for a in (
            self._prompt_buf, self._prompt_len, self._max_new, self._active)]
        samp = self._sampling()
        ticket = obs.mark_dispatch("serve.decode_block")
        with obs.span("serve.decode_block", k=self.k, live=live):
            self.state, toks, emitted = self._block(
                self.params, self.state, *inputs, samp, page_table)
            st = self.state
            packed = torch.cat([toks.reshape(-1),
                                emitted.reshape(-1).to(torch.int32),
                                st.done.to(torch.int32),
                                st.eos_hit.to(torch.int32), st.lengths])
            host = event = None
            if self.device.type == "cuda":
                host = torch.empty(packed.shape, dtype=packed.dtype,
                                   pin_memory=True)
                host.copy_(packed, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
        return _InFlight(packed, host, event, list(self._slot_req),
                         self._active.copy(), live, ticket)

    def _fetch(self, inf: _InFlight) -> np.ndarray:
        """The round's single host sync: on a card, wait for the pinned
        copy's event; on the CPU, read the packed tensor."""
        if inf.event is None:
            return inf.packed.numpy()
        inf.event.synchronize()
        return inf.host.numpy()

    def _complete_block(self, inf: _InFlight
                        ) -> Tuple[List[StreamDelta], List[Response]]:
        """Fetch one in-flight block's outputs, then the host half of the
        round: stats, prefix publishing, token extension, retirement.
        Completion only touches slots the block owned at launch."""
        # fence release: slots retired while ``inf`` was in flight return
        # to the pool only now
        for slot in inf.deferred:
            self.pool.free(slot)
        overlapped = bool(self._pipe)   # a newer block is already in flight
        B = self.pool.num_slots
        k = self.k
        obs.mark_fetch(inf.ticket)
        t0 = time.perf_counter()
        with obs.span("serve.decode_block", k=k, live=inf.live, fetch=1):
            flat = self._fetch(inf)
        blocked = time.perf_counter() - t0
        toks = flat[:k * B].reshape(k, B)
        emitted = flat[k * B:2 * k * B].reshape(k, B).astype(bool)
        done = flat[2 * k * B:2 * k * B + B].astype(bool)
        eos_hit = flat[2 * k * B + B:2 * k * B + 2 * B].astype(bool)
        len_after = flat[2 * k * B + 2 * B:]
        out: List[Response] = []
        deltas: List[StreamDelta] = []
        self.stats.syncs += 1
        self.stats.steps += k
        self.stats.occupancy_sum += inf.live / B
        self.stats.host_blocked_s += blocked
        if overlapped:
            self.stats.hidden_syncs += 1
        # host length mirror: only rows this block owned advanced; rows
        # admitted while it was in flight keep their admission-time value
        plen = self._prompt_len
        new_prefill = int(
            (np.minimum(len_after, plen) - np.minimum(self._len_host, plen))
            [inf.active].sum())
        self.stats.prefill_tokens += new_prefill
        self._len_host = np.where(inf.active, len_after, self._len_host)
        on = obs.enabled()
        if on:
            _M_SYNCS.inc()
            _M_STEPS.inc(k)
            _M_PREFILL.inc(new_prefill)
            _M_BLOCKED.observe(blocked)
            if overlapped:
                _M_HIDDEN.inc()
        if self.prefix_on:
            # publish fully written whole-prompt pages to the trie before
            # the retire loop releases this round's finished slots
            for slot in inf.slots:
                if slot in self._slot_req:
                    self.pool.register_prefix(slot, self._slot_prompt[slot],
                                              int(len_after[slot]))
        end = self.scheduler.clock()   # same clock as admission timestamps
        for slot in inf.slots:
            if slot not in self._slot_req:
                continue                # retired by an earlier completion
            got = [int(t) for t in toks[:, slot][emitted[:, slot]]]
            self._slot_toks[slot].extend(got)
            self.stats.tokens_out += len(got)
            if on and got:
                _M_TOKENS.inc(len(got))
                if slot not in self._slot_first:
                    # first tokens of the block all land at the sync, so
                    # TTFT is block-granular
                    ttft = end - self._slot_req[slot].arrival_s
                    self._slot_first[slot] = ttft
                    _M_TTFT.observe(ttft)
            stream = self._slot_stream.get(slot, 0)
            if not done[slot]:
                if got:
                    deltas.append(StreamDelta(id=self._slot_req[slot].id,
                                              tokens=got, stream=stream))
                continue
            r = self._slot_req.pop(slot)
            seq = self._slot_toks.pop(slot)
            t_adm = self._slot_t0.pop(slot)
            self._slot_stream.pop(slot, None)
            self._slot_prompt.pop(slot, None)
            # the reason comes from the device-side done branch: a length
            # retirement whose last token equals eos_id is still a length
            # finish
            reason = FINISH_EOS if eos_hit[slot] else FINISH_LENGTH
            resp = Response(id=r.id, tokens=seq, finish_reason=reason,
                            prompt_len=len(r.prompt),
                            queue_wait_s=t_adm - r.arrival_s,
                            latency_s=end - r.arrival_s, stream=stream)
            # the request is fully retired when its last stream finishes
            left = self._groups.get(r.id)
            if left is not None:
                if left <= 1:
                    del self._groups[r.id]
                else:
                    self._groups[r.id] = left - 1
            ttft = self._slot_first.pop(slot, None)
            if on:
                _M_REQS.inc(reason=reason)
                _M_LATENCY.observe(resp.latency_s)
                if ttft is not None and len(seq) > 1:
                    _M_TPOT.observe((resp.latency_s - ttft) / (len(seq) - 1))
                obs.instant("serve.retire", id=r.id, reason=reason,
                            tokens=len(seq))
            out.append(resp)
            deltas.append(StreamDelta(id=r.id, tokens=got, done=True,
                                      response=resp, stream=stream))
            if self._pipe:
                # stale-slot fence: a newer in-flight block still owns this
                # row; defer the pool free until that block completes
                self._pipe[-1].deferred.append(slot)
            else:
                self.pool.free(slot)
            self._active[slot] = False
            # reset the slot's policy with it: a stale temperature in a
            # freed slot would keep the all-greedy batch off the fast path
            self._temp[slot] = 0.0
            self._top_p[slot] = 1.0
            self._top_k[slot] = 0
            self.stats.retired += 1
        return deltas, out

    # ---------------------------------------------------------------- step
    def stream_step(self, now: Optional[float] = None
                    ) -> Tuple[List[StreamDelta], List[Response]]:
        """One scheduling round + one k-step block + one host sync.

        Returns ``(deltas, responses)``: ``responses`` are the round's
        completed requests (retired / shed / rejected — the ``step()``
        contract); ``deltas`` also carry the tokens every live request
        gained this block. The round clock is taken at entry, before the
        launch and before waiting for any earlier block, so deadline waits
        are measured against launch time."""
        now = self.scheduler.clock() if now is None else now
        with obs.span("serve.admit"):
            out = self._admit(now)
        # shed / rejected requests never held a slot: terminal delta only
        deltas = [StreamDelta(id=r.id, tokens=[], done=True, response=r)
                  for r in out]
        if not self.overlap:
            if self._active.any():
                d, o = self._complete_block(self._launch_block())
                deltas += d
                out += o
                self._maybe_defrag()
            return deltas, out
        if self._active.any():
            self._pipe.append(self._launch_block())
        # keep the pipeline one deep: fetch the oldest block once a newer
        # one is in flight, and drain fully when nothing new was launched
        while self._pipe and (len(self._pipe) > 1
                              or not self._active.any()):
            d, o = self._complete_block(self._pipe.pop(0))
            deltas += d
            out += o
        if self._needs_defrag():
            # structural slot/page moves: flush the pipeline first
            while self._pipe:
                d, o = self._complete_block(self._pipe.pop(0))
                deltas += d
                out += o
            self._maybe_defrag()
        return deltas, out

    def step(self, now: Optional[float] = None) -> List[Response]:
        """One scheduling round + one k-step block + one host sync; returns
        the round's completed responses."""
        return self.stream_step(now)[1]

    # ----------------------------------------------------------------- run
    def _drained(self) -> bool:
        return (not len(self.scheduler) and self.pool.live_count == 0
                and not self._pipe)

    def run(self, requests: Iterable[Request] = (), *,
            max_syncs: int = 1_000_000) -> List[Response]:
        """Drain: submit ``requests``, then step until queue and slots empty."""
        for r in requests:
            self.submit(r)
        out: List[Response] = []
        for _ in range(max_syncs):
            if self._drained():
                return out
            out.extend(self.step())
        # a workload that drains in exactly max_syncs rounds is a success
        if self._drained():
            return out
        raise RuntimeError(f"engine did not drain within {max_syncs} syncs")

    def stream(self, requests: Iterable[Request] = (), *,
               max_syncs: int = 1_000_000) -> Iterator[StreamDelta]:
        """Streaming drain: yields a ``StreamDelta`` per request per block as
        tokens land; each request's final delta has ``done=True`` and
        carries its ``Response``."""
        for r in requests:
            self.submit(r)
        for _ in range(max_syncs):
            if self._drained():
                return
            deltas, _ = self.stream_step()
            yield from deltas
        if self._drained():
            return
        raise RuntimeError(f"engine did not drain within {max_syncs} syncs")

"""Continuous-batching engine: ingest queue -> schedule -> k-step decode ->
retire slots -> stats (the counterpart of ``repro.serve.engine``).

One ``step()`` is one scheduling round plus one k-step block: admit queued
requests into free cache slots (their prompts go into the host prompt
buffer, reused slot rows are zeroed), copy the block's host inputs to the
card, run the block, then make the round's single host sync — one
device->host fetch of the k emitted tokens and the per-slot done masks —
extend per-request outputs, and retire finished slots. Every shape
(num_slots, max_prompt, k) is fixed at construction.

Ported so far: greedy decode over the slot pool or the paged pool
(``page_size``, ``kv_dtype`` f32 or int8), ``eos_id``, slot and page
defrag, ``step``/``run``/``stream_step``/``stream`` and ``EngineStats``.
Sampled requests (``temperature > 0``), fan-out (``n > 1``), the prefix
cache and the double-buffered loop (``overlap``) raise
``NotImplementedError``: they come with the rest of serving (ROADMAP
queue 1 item 8).

Observability (``repro_torch.obs``): the JAX engine's counters and
histograms under its names (those of the features item 8 brings — prefix
hits and tokens, COW copies, hidden syncs — are defined and stay at 0),
the ``serve.admit`` span and instant, the ``serve.decode_block`` spans
around the block and around its fetch, the ``serve.retire`` instant, and
``mark_dispatch("serve.decode_block")`` before each block, so a sync audit
counts one round trip per block, equal to ``EngineStats.syncs``. Each
round's mutations sit behind one ``obs.enabled()`` check.

Token streams do not depend on k: every step runs at the shape
(num_slots, 1), and each row's result depends on that row alone.
"""
from __future__ import annotations

import time
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs, resolve_device, to_device
from repro_torch.serve.api import (Request, Response, EngineStats, StreamDelta,
                                   FINISH_EOS, FINISH_ERROR, FINISH_LENGTH,
                                   FINISH_SHED)
from repro_torch.serve.cache import CachePool
from repro_torch.serve.decode import init_decode_state, make_decode_block
from repro_torch.serve.paging import PagedCachePool
from repro_torch.serve.scheduler import Scheduler

_LATER = "the rest of serving (ROADMAP queue 1 item 8)"

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


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; it comes with "
                               f"{_LATER}")


class _Block:
    """One run k-step block's device outputs, fetched at completion."""

    __slots__ = ("toks", "emitted", "done", "eos_hit", "lengths", "slots",
                 "active", "live", "ticket")

    def __init__(self, toks, emitted, done, eos_hit, lengths, slots, active,
                 live, ticket):
        self.toks = toks                # (k, B) device tokens
        self.emitted = emitted          # (k, B) device emit mask
        self.done = done                # (B,) device done mask (post-block)
        self.eos_hit = eos_hit          # (B,) device eos branch
        self.lengths = lengths          # (B,) device lengths (post-block)
        self.slots = slots              # slot ids owned at dispatch
        self.active = active            # (B,) host bool snapshot at dispatch
        self.live = live                # active slot count at dispatch
        self.ticket = ticket            # obs.mark_dispatch ticket


class Engine:
    """Continuous-batching serving engine (greedy) over a slot or paged pool.

    params/cfg: model weights + a dense arch config. device: where the
    cache lives and the block runs; ``cuda`` unless the caller asks for
    another (raises with no card). num_slots: concurrent sequences (the
    block's batch dimension). max_len: per-slot cache depth; k: decode
    steps per host sync. eos_id: stop a slot on this token (None:
    length-only). scheduler: admission policy; default plain FIFO (pass
    ``Scheduler(gate=DeadlineGate(...))`` for overload shedding).
    page_size: put the K/V leaves in a paged pool with this many tokens per
    page; None keeps the whole-row slot layout. num_pages: page-pool depth
    override. kv_dtype: ``"f32"`` keeps the init_cache dtypes (bf16 K/V);
    ``"int8"`` (paged pools only) stores int8 codes with per-(page row,
    head) float32 scales. sync_debug: run each block under
    ``torch.cuda.set_sync_debug_mode("error")`` so a hidden host sync in it
    raises (a card only).
    """

    def __init__(self, params, cfg, *, num_slots: int = 8,
                 max_len: int = 128, k: int = 4,
                 max_prompt: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 scheduler: Optional[Scheduler] = None,
                 defrag_threshold: float = 0.5,
                 page_size: Optional[int] = None,
                 prefix_cache: bool = False,
                 num_pages: Optional[int] = None,
                 kv_dtype: str = "f32",
                 overlap: bool = False,
                 device=None, sync_debug: bool = False):
        if prefix_cache:
            raise _unported("the prefix cache (prefix_cache=True)")
        if overlap:
            raise _unported("the double-buffered loop (overlap=True)")
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.k = int(k)
        self.max_len = int(max_len)
        self.max_prompt = int(max_prompt if max_prompt is not None
                              else max_len)
        self.eos_id = eos_id
        if kv_dtype != "f32" and page_size is None:
            raise ValueError("kv_dtype requires a paged pool: pass page_size")
        if page_size is not None:
            pool = PagedCachePool(cfg, num_slots, max_len,
                                  page_size=page_size, num_pages=num_pages,
                                  kv_dtype=kv_dtype, device=self.device)
        else:
            pool = CachePool(cfg, num_slots, max_len, device=self.device)
        self.pool = pool
        self.paged = isinstance(pool, PagedCachePool)
        self.scheduler = scheduler if scheduler is not None else Scheduler()
        self.defrag_threshold = float(defrag_threshold)
        self._block = make_decode_block(
            cfg, k=self.k, max_len=self.max_len, eos_id=eos_id,
            sync_debug=sync_debug and self.device.type == "cuda")
        self.state = init_decode_state(self.pool.make_cache(), num_slots,
                                       self.device)
        B, P = num_slots, self.max_prompt
        self._prompt_buf = np.zeros((B, P), np.int32)
        self._prompt_len = np.zeros((B,), np.int32)
        self._len_host = np.zeros((B,), np.int32)   # host mirror of lengths
        self._max_new = np.ones((B,), np.int32)
        self._active = np.zeros((B,), bool)
        self._slot_req: dict = {}
        self._slot_toks: dict = {}
        self._slot_t0: dict = {}
        self._slot_first: dict = {}     # slot -> TTFT (recorded with obs on)
        self.stats = EngineStats()

    # -------------------------------------------------------------- ingest
    def submit(self, req: Request) -> None:
        """Enqueue a request. Malformed requests (empty prompt) raise at
        once, and so do the options not ported yet; an over-long prompt is
        accepted here but rejected with a ``finish_reason="error"``
        Response at admission."""
        if len(req.prompt) < 1:
            raise ValueError(f"request {req.id}: empty prompt")
        n_streams = int(req.n) if req.n is not None else 1
        if n_streams < 1:
            raise ValueError(f"request {req.id}: n must be >= 1, "
                             f"got {req.n}")
        if n_streams > 1:
            raise _unported(f"request {req.id}: fan-out (n={n_streams})")
        if req.sampling is not None and not req.sampling.greedy:
            raise _unported(f"request {req.id}: sampling (temperature="
                            f"{req.sampling.temperature})")
        self.scheduler.submit(req)

    # -------------------------------------------------------------- admit
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
        slots: List[int] = []
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
            slot = self.pool.allocate(r.id)
            slots.append(slot)
            self.pool.zero_slot(self.state.cache, slot)
            self._prompt_buf[slot, :] = 0
            self._prompt_buf[slot, :n] = np.asarray(r.prompt, np.int32)
            self._prompt_len[slot] = n
            self._len_host[slot] = 0
            self._max_new[slot] = max(int(r.max_new_tokens), 1)
            self._active[slot] = True
            self._slot_req[slot] = r
            self._slot_toks[slot] = []
            self._slot_t0[slot] = now
            self.stats.admitted += 1
            if on:
                obs.instant("serve.admit", id=r.id, slot=slot, prompt_len=n,
                            prefix_reused=0, stream=0)
                _M_QWAIT.observe(now - r.arrival_s)
        if slots:
            # index_fill_ takes the value as a host scalar: ``t[idx] = 0``
            # would copy a CPU scalar tensor to the card, a host sync
            idx = to_device(np.asarray(slots, np.int64), self.device)
            st = self.state
            for t in (st.lengths, st.last_tok, st.n_out):
                t.index_fill_(0, idx, 0)
            for t in (st.done, st.eos_hit):
                t.index_fill_(0, idx, False)
        return out

    # -------------------------------------------------------------- defrag
    def _maybe_defrag(self) -> None:
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
            self._prompt_buf = self._prompt_buf[hperm]
            self._prompt_len = self._prompt_len[hperm]
            self._len_host = self._len_host[hperm]
            self._max_new = self._max_new[hperm]
            self._active = self._active[hperm]
            self._slot_req = {mapping[s]: r
                              for s, r in self._slot_req.items()}
            self._slot_toks = {mapping[s]: t
                               for s, t in self._slot_toks.items()}
            self._slot_t0 = {mapping[s]: t
                             for s, t in self._slot_t0.items()}
            self._slot_first = {mapping[s]: t
                                for s, t in self._slot_first.items()}
            self.stats.defrags += 1
            if obs.enabled():
                _M_DEFRAGS.inc(kind="slot")
        if self.paged and \
                self.pool.page_fragmentation() >= self.defrag_threshold:
            # a page permutation: slot contents are unchanged
            self.state.cache = self.pool.defrag_pages(self.state.cache)
            self.stats.page_defrags += 1
            if obs.enabled():
                _M_DEFRAGS.inc(kind="page")

    # ------------------------------------------------------- run/fetch
    def _run_block(self) -> _Block:
        """Copy the block's host inputs to the card, then run the k-step
        block: it enqueues work and reads nothing back."""
        live = int(self._active.sum())
        page_table = None
        if self.paged:
            # reserve pages for every position this block can write, so the
            # table is constant across its k steps
            for slot in self._slot_req:
                self.pool.reserve(slot, int(self._len_host[slot]) + self.k)
            page_table = to_device(self.pool.tables, self.device)
            self.stats.peak_live_pages = max(self.stats.peak_live_pages,
                                             self.pool.live_page_count())
        inputs = [to_device(a, self.device) for a in (
            self._prompt_buf, self._prompt_len, self._max_new, self._active)]
        ticket = obs.mark_dispatch("serve.decode_block")
        with obs.span("serve.decode_block", k=self.k, live=live):
            self.state, toks, emitted = self._block(
                self.params, self.state, *inputs, page_table)
        return _Block(toks, emitted, self.state.done, self.state.eos_hit,
                      self.state.lengths, list(self._slot_req),
                      self._active.copy(), live, ticket)

    def _complete_block(self, blk: _Block
                        ) -> Tuple[List[StreamDelta], List[Response]]:
        """The round's single host sync — one device->host transfer of the
        block's tokens, emit mask, done and eos masks and lengths — then the
        host half of the round: stats, token extension, retirement."""
        k, B = blk.toks.shape
        obs.mark_fetch(blk.ticket)
        t0 = time.perf_counter()
        with obs.span("serve.decode_block", k=self.k, live=blk.live,
                      fetch=1):
            flat = torch.cat([blk.toks.reshape(-1),
                              blk.emitted.reshape(-1).to(torch.int32),
                              blk.done.to(torch.int32),
                              blk.eos_hit.to(torch.int32),
                              blk.lengths]).cpu().numpy()
        blocked = time.perf_counter() - t0
        self.stats.host_blocked_s += blocked
        toks = flat[:k * B].reshape(k, B)
        emitted = flat[k * B:2 * k * B].reshape(k, B).astype(bool)
        done = flat[2 * k * B:2 * k * B + B].astype(bool)
        eos_hit = flat[2 * k * B + B:2 * k * B + 2 * B].astype(bool)
        len_after = flat[2 * k * B + 2 * B:]
        out: List[Response] = []
        deltas: List[StreamDelta] = []
        self.stats.syncs += 1
        self.stats.steps += self.k
        self.stats.occupancy_sum += blk.live / self.pool.num_slots
        plen = self._prompt_len
        new_prefill = int(
            (np.minimum(len_after, plen) - np.minimum(self._len_host, plen))
            [blk.active].sum())
        self.stats.prefill_tokens += new_prefill
        self._len_host = np.where(blk.active, len_after, self._len_host)
        on = obs.enabled()
        if on:
            _M_SYNCS.inc()
            _M_STEPS.inc(self.k)
            _M_PREFILL.inc(new_prefill)
            _M_BLOCKED.observe(blocked)
        end = self.scheduler.clock()   # same clock as admission timestamps
        for slot in blk.slots:
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
            if not done[slot]:
                if got:
                    deltas.append(StreamDelta(id=self._slot_req[slot].id,
                                              tokens=got))
                continue
            r = self._slot_req.pop(slot)
            seq = self._slot_toks.pop(slot)
            t_adm = self._slot_t0.pop(slot)
            # the reason comes from the device-side done branch: a length
            # retirement whose last token equals eos_id is still a length
            # finish
            reason = FINISH_EOS if eos_hit[slot] else FINISH_LENGTH
            resp = Response(id=r.id, tokens=seq, finish_reason=reason,
                            prompt_len=len(r.prompt),
                            queue_wait_s=t_adm - r.arrival_s,
                            latency_s=end - r.arrival_s)
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
                                      response=resp))
            self.pool.free(slot)
            self._active[slot] = False
            self.stats.retired += 1
        return deltas, out

    # ---------------------------------------------------------------- step
    def stream_step(self, now: Optional[float] = None
                    ) -> Tuple[List[StreamDelta], List[Response]]:
        """One scheduling round + one k-step block + one host sync.

        Returns ``(deltas, responses)``: ``responses`` are the round's
        completed requests (retired / shed / rejected — the ``step()``
        contract); ``deltas`` also carry the tokens every live request
        gained this block."""
        now = self.scheduler.clock() if now is None else now
        with obs.span("serve.admit"):
            out = self._admit(now)
        # shed / rejected requests never held a slot: terminal delta only
        deltas = [StreamDelta(id=r.id, tokens=[], done=True, response=r)
                  for r in out]
        if self._active.any():
            d, o = self._complete_block(self._run_block())
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
        return not len(self.scheduler) and self.pool.live_count == 0

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

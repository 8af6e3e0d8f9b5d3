"""Public request/response/stats types for the serving engine (the
counterpart of ``repro.serve.api``, field for field).

Pure-host dataclasses: nothing here touches a device, so schedulers and
drivers can be unit-tested without one.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.serve.sampling import SamplingParams

FINISH_EOS = "eos"          # model emitted the eos token
FINISH_LENGTH = "length"    # hit max_new_tokens (or the cache ran out)
FINISH_SHED = "shed"        # rejected by overload admission, never decoded
FINISH_ERROR = "error"      # invalid request (e.g. prompt exceeds engine
                            # bounds), rejected at admission without a slot


@dataclasses.dataclass
class Request:
    """One generation request.

    prompt: token ids (≥ 1; the last prompt token primes the first decode).
    enc_embeds: (enc_len, d_model) array for enc-dec (whisper) archs — the
    audio frontend is a stub repo-wide, so callers pass frame embeddings.
    sampling: decode policy; None (or the default ``SamplingParams()``) is
    greedy argmax, bit-identical to the pre-sampling engine.
    n: parallel samples per request. The engine fans the request into n
    streams that share the prompt's KV pages (paged pool) and draw from
    ``fold_in(request_key, stream)`` — stream i is bit-identical to a
    standalone request seeded with that derived key. Responses/deltas carry
    ``stream`` ∈ [0, n); the request retires when all n streams finish.
    """
    id: str
    prompt: Sequence[int]
    max_new_tokens: int = 16
    enc_embeds: Optional[object] = None
    sampling: Optional[SamplingParams] = None
    n: int = 1
    arrival_s: Optional[float] = None       # stamped by the engine at submit


@dataclasses.dataclass
class Response:
    id: str
    tokens: List[int]                        # generated ids (prompt excluded)
    finish_reason: str                       # FINISH_EOS | FINISH_LENGTH
                                             # | FINISH_SHED | FINISH_ERROR
    prompt_len: int = 0
    queue_wait_s: float = 0.0                # submit -> slot assignment
    latency_s: float = 0.0                   # submit -> retirement
    stream: int = 0                          # sample index for n>1 requests


@dataclasses.dataclass
class StreamDelta:
    """Per-request token increment from one fused k-block.

    ``Engine.stream_step`` yields one delta per request that progressed in
    the round: ``tokens`` are the block's newly emitted ids (possibly empty
    when the request finished without new tokens — shed/rejected/EOS-edge),
    ``done`` marks retirement, and ``response`` carries the final
    :class:`Response` exactly when ``done`` is True.
    """
    id: str
    tokens: List[int]
    done: bool = False
    response: Optional[Response] = None
    stream: int = 0                          # sample index for n>1 requests


@dataclasses.dataclass
class EngineStats:
    """Aggregate engine counters; ``syncs`` is the host<->device round-trip
    count — the quantity the k-step fused decode divides by k."""
    syncs: int = 0                           # fused-block dispatches
    steps: int = 0                           # model decode steps (= syncs * k)
    tokens_out: int = 0                      # tokens delivered to responses
    prefill_tokens: int = 0                  # prompt tokens consumed in-loop
    admitted: int = 0
    retired: int = 0
    shed: int = 0
    rejected: int = 0                        # invalid at admission (error)
    defrags: int = 0
    occupancy_sum: float = 0.0               # live-slot fraction, per sync
    # paged-pool counters (zero on the slot-layout engine)
    prefix_hits: int = 0                     # admissions that matched the trie
    prefix_tokens: int = 0                   # prefill tokens skipped via reuse
    cow_copies: int = 0                      # copy-on-write divergence pages
    page_defrags: int = 0                    # page-pool compactions
    peak_live_pages: int = 0                 # high-water pool occupancy
    # n>1 fan-out counters
    fanout_groups: int = 0                   # admitted requests with n > 1
    fanout_streams: int = 0                  # streams admitted via fan-out
    shared_prompt_pages: int = 0             # sibling table entries that map
                                             # a page instead of refilling it
    # double-buffered loop counters (zero on the non-overlapped engine)
    hidden_syncs: int = 0                    # block fetches made while a newer
                                             # block was already in flight
    host_blocked_s: float = 0.0              # wall time blocked fetching
                                             # k-block results (all syncs)

    @property
    def occupancy(self) -> float:
        return self.occupancy_sum / self.syncs if self.syncs else 0.0

    @property
    def blocking_syncs(self) -> int:
        """Syncs with no newer block in flight — true pipeline stalls."""
        return self.syncs - self.hidden_syncs

    @property
    def host_blocked_per_sync(self) -> float:
        """Mean host wall time blocked per k-block result fetch — the number
        the double-buffered loop exists to shrink."""
        return self.host_blocked_s / self.syncs if self.syncs else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admissions that matched the prefix trie."""
        return self.prefix_hits / self.admitted if self.admitted else 0.0

    @property
    def tokens_per_sync(self) -> float:
        """Delivered tokens per host round trip — the serving-side realization
        of the paper's per-sync work amplification (ideal: k at saturation)."""
        return self.tokens_out / self.syncs if self.syncs else 0.0

    def summary(self) -> str:
        """One-line human summary (the launch CLIs print this at exit)."""
        s = (f"summary: syncs={self.syncs} steps={self.steps} "
             f"tokens_out={self.tokens_out} "
             f"tokens_per_sync={self.tokens_per_sync:.2f} "
             f"admitted={self.admitted} retired={self.retired} "
             f"shed={self.shed} rejected={self.rejected} "
             f"occupancy={self.occupancy:.2f}")
        if self.prefix_hits or self.cow_copies or self.page_defrags:
            s += (f" prefix_hit_rate={self.prefix_hit_rate:.2f} "
                  f"prefix_tokens={self.prefix_tokens} "
                  f"cow_copies={self.cow_copies}")
        if self.fanout_groups:
            s += (f" fanout_groups={self.fanout_groups} "
                  f"fanout_streams={self.fanout_streams} "
                  f"shared_prompt_pages={self.shared_prompt_pages}")
        if self.hidden_syncs:
            s += (f" hidden_syncs={self.hidden_syncs} "
                  f"blocking_syncs={self.blocking_syncs} "
                  f"host_blocked_per_sync="
                  f"{self.host_blocked_per_sync * 1e3:.3f}ms")
        return s

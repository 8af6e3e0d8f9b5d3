"""Serving: continuous batching with communication-avoiding k-step decode
(the counterpart of ``repro.serve``, greedy so far).

- ``api``       — ``Request`` / ``Response`` / ``StreamDelta`` /
                  ``EngineStats``.
- ``sampling``  — ``SamplingParams`` (validated; only greedy is served).
- ``cache``     — ``CachePool``: slot-based KV cache (allocate / free /
                  defrag).
- ``paging``    — ``PagedCachePool``: fixed-size pages behind per-slot page
                  tables, refcounts, page defrag, optional int8 pages.
- ``scheduler`` — FIFO admission + ``DeadlineGate`` overload shedding.
- ``decode``    — the k-step decode block: k tokens per host sync.
- ``engine``    — the run loop: ingest -> schedule -> k-step decode ->
                  retire -> stats.
"""
from repro_torch.serve.api import (Request, Response, StreamDelta, EngineStats,
                                   FINISH_EOS, FINISH_ERROR, FINISH_LENGTH,
                                   FINISH_SHED)
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.cache import CachePool, SlotError
from repro_torch.serve.paging import PagedCachePool, PageError
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.decode import (DecodeState, init_decode_state,
                                      make_decode_block)
from repro_torch.serve.engine import Engine

__all__ = [
    "Request", "Response", "StreamDelta", "EngineStats",
    "FINISH_EOS", "FINISH_ERROR", "FINISH_LENGTH", "FINISH_SHED",
    "SamplingParams", "CachePool", "SlotError", "Scheduler",
    "PagedCachePool", "PageError",
    "DecodeState", "init_decode_state", "make_decode_block", "Engine",
]

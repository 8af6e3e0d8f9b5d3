"""Serving: continuous batching with communication-avoiding k-step decode
(the counterpart of ``repro.serve``).

- ``api``       — ``Request`` / ``Response`` / ``StreamDelta`` /
                  ``EngineStats``.
- ``sampling``  — ``SamplingParams``, ``SlotSampling``, the on-device
                  sampler with JAX's threefry draws, ``host_fold_in``.
- ``cache``     — ``CachePool``: slot-based cache of every family
                  (allocate / free / defrag, per-slot PRNG keys).
- ``paging``    — ``PagedCachePool``: fixed-size pages behind per-slot page
                  tables, refcounts, page defrag, optional int8 pages;
                  ``PrefixCache``: the radix trie of shared prompt pages.
- ``scheduler`` — FIFO admission + ``DeadlineGate`` overload shedding.
- ``decode``    — the k-step decode block: k tokens per host sync.
- ``engine``    — the run loop: ingest -> schedule -> k-step decode ->
                  retire -> stats; fan-out, the prefix cache and the
                  double-buffered loop.
"""
from repro_torch.serve.api import (Request, Response, StreamDelta, EngineStats,
                                   FINISH_EOS, FINISH_ERROR, FINISH_LENGTH,
                                   FINISH_SHED)
from repro_torch.serve.sampling import (SamplingParams, SlotSampling,
                                        fold_in_seed, host_fold_in,
                                        sample_tokens)
from repro_torch.serve.cache import CachePool, SlotError
from repro_torch.serve.paging import PagedCachePool, PageError, PrefixCache
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.decode import (DecodeState, init_decode_state,
                                      make_decode_block)
from repro_torch.serve.engine import Engine

__all__ = [
    "Request", "Response", "StreamDelta", "EngineStats",
    "FINISH_EOS", "FINISH_ERROR", "FINISH_LENGTH", "FINISH_SHED",
    "SamplingParams", "SlotSampling", "sample_tokens", "host_fold_in",
    "fold_in_seed", "CachePool", "SlotError", "Scheduler",
    "PagedCachePool", "PageError", "PrefixCache",
    "DecodeState", "init_decode_state", "make_decode_block", "Engine",
]

"""repro_torch.obs — zero-overhead-when-disabled observability (the
counterpart of ``repro.obs``, with its public names).

Three pillars, one switch:

- ``spans``      — nested wall-clock spans + instant events, thread-safe,
                   exported as Chrome-trace/Perfetto JSON (``write_trace``).
- ``metrics``    — labeled counter/gauge/histogram registry, exported as
                   Prometheus text (``write_prometheus``) or JSONL.
- ``sync_audit`` — a context manager counting host<->device synchronization
                   points on a given device (torch's blocking reads,
                   coalesced into round-trip epochs at ``mark_dispatch``
                   boundaries, cross-checked on a card by the CUDA
                   runtime's sync-debug mode) — the empirical check of the
                   paper's CA-k sync-per-k-steps claim. ``mark_dispatch``
                   returns a ticket; a loop announces the ticket it is about
                   to block on via ``mark_fetch``, and epochs that fetch a
                   stale ticket count as ``overlap_epochs`` (hidden syncs).

``enable()`` turns span/metric recording on (the launch CLIs do this from
``--metrics``/``--trace-out``); while disabled every instrumentation point
costs one boolean check. ``sync_audit()`` is independent of the switch: the
context itself opts in, and its torch patches exist only while it is active.
"""
from repro_torch.obs.state import enable, disable, enabled
from repro_torch.obs.spans import (NOOP, span, instant, current,
                                   to_chrome_trace, write_trace)
from repro_torch.obs import spans as _spans
from repro_torch.obs import metrics
from repro_torch.obs.metrics import (REGISTRY, counter, gauge, histogram,
                                     to_prometheus, to_jsonl,
                                     write_prometheus, write_jsonl)
from repro_torch.obs.sync_audit import (SyncAudit, sync_audit, mark_dispatch,
                                        mark_fetch)


def metrics_snapshot() -> dict:
    """Flat ``{name{labels}: value}`` view of every recorded metric."""
    return REGISTRY.snapshot()


def reset() -> None:
    """Clear collected spans and metric values (handles stay valid)."""
    _spans.reset()
    REGISTRY.reset()


__all__ = [
    "enable", "disable", "enabled", "reset",
    "NOOP", "span", "instant", "current", "to_chrome_trace", "write_trace",
    "metrics", "REGISTRY", "counter", "gauge", "histogram",
    "to_prometheus", "to_jsonl", "write_prometheus", "write_jsonl",
    "metrics_snapshot",
    "SyncAudit", "sync_audit", "mark_dispatch", "mark_fetch",
]

"""Nested wall-clock spans with thread-safe context and Chrome-trace export
(a copy of ``repro.obs.spans``; the trace names the same producer).

A span is one timed region of host code (``with span("serve.step"): ...``);
spans nest through a thread-local stack, so a trace viewer reconstructs the
flame graph from start/duration alone. Finished spans accumulate in a
process-global bounded buffer and export as Chrome ``traceEvents`` JSON —
loadable in ``chrome://tracing`` or Perfetto (https://ui.perfetto.dev).

Zero-overhead-when-disabled contract: ``span()``/``instant()`` check the
:mod:`repro_torch.obs.state` switch first and return a shared no-op
context manager (no allocation, no clock read) when it is off.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.obs import state

#: buffer cap — a runaway loop must not grow host memory without bound;
#: overflow is counted and reported in the exported trace metadata
MAX_EVENTS = 200_000

_lock = threading.Lock()
_events: List[dict] = []        # finished spans + instants, chrome-trace form
_dropped = 0
_epoch = time.perf_counter()    # trace time zero

_tls = threading.local()        # .stack: list of active span names


def _stack() -> List[str]:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


class _NoopSpan:
    """Shared do-nothing context manager returned while obs is disabled."""
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


NOOP = _NoopSpan()


class Span:
    """One active timed region; records itself into the buffer on exit."""
    __slots__ = ("name", "args", "_t0")

    def __init__(self, name: str, args: Optional[Dict[str, Any]]):
        self.name = name
        self.args = args

    def __enter__(self) -> "Span":
        _stack().append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = time.perf_counter()
        _stack().pop()
        ev = dict(name=self.name, ph="X", pid=os.getpid(),
                  tid=threading.get_ident(),
                  ts=(self._t0 - _epoch) * 1e6, dur=(t1 - self._t0) * 1e6)
        if self.args:
            ev["args"] = self.args
        _record(ev)
        return False


def _record(ev: dict) -> None:
    global _dropped
    with _lock:
        if len(_events) >= MAX_EVENTS:
            _dropped += 1
        else:
            _events.append(ev)


def span(name: str, **args: Any):
    """Open a nested wall-clock span; no-op (shared object) when disabled."""
    if not state.enabled():
        return NOOP
    return Span(name, args or None)


def instant(name: str, **args: Any) -> None:
    """Record a zero-duration marker (e.g. a request lifecycle edge)."""
    if not state.enabled():
        return
    ev = dict(name=name, ph="i", s="t", pid=os.getpid(),
              tid=threading.get_ident(),
              ts=(time.perf_counter() - _epoch) * 1e6)
    if args:
        ev["args"] = args
    _record(ev)


def current() -> str:
    """Name of the innermost active span on this thread ("" outside any)."""
    stack = _stack()
    return stack[-1] if stack else ""


def reset() -> None:
    """Drop all collected events (tests and CLI run boundaries)."""
    global _dropped, _epoch
    with _lock:
        del _events[:]
        _dropped = 0
        _epoch = time.perf_counter()


def to_chrome_trace() -> dict:
    """The collected events as a Chrome-trace/Perfetto JSON object."""
    with _lock:
        events = list(_events)
        dropped = _dropped
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"producer": "repro.obs", "dropped": dropped}}


def write_trace(path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(), f)

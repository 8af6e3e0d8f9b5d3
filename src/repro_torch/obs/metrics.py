"""Counter/gauge/histogram registry with labels, Prometheus-text and JSONL
export (a copy of ``repro.obs.metrics``).

Metrics are named process-global objects created get-or-create through the
default :class:`Registry` (module-level :func:`counter` / :func:`gauge` /
:func:`histogram`), so instrumented modules can hold handles at import time
without caring who created them first. Each metric keeps one value per label
set (labels are passed as kwargs to ``inc``/``set``/``observe``).

Mutations early-return while :mod:`repro_torch.obs.state` is disabled —
call sites in hot loops pay one function call and a boolean check, nothing
else.
Reads (``value``/``snapshot``/exports) always work, so a test or exporter
can inspect whatever was recorded while enabled.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import state

LabelKey = Tuple[Tuple[str, str], ...]

#: default histogram buckets: seconds, spanning 100us..60s latencies
DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class Metric:
    """Shared naming/locking base; subclasses hold per-label-set state."""
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def label_sets(self) -> List[LabelKey]:
        raise NotImplementedError

    def prometheus_lines(self) -> List[str]:
        raise NotImplementedError

    def samples(self) -> List[dict]:
        """Flat sample dicts for the JSONL export."""
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class Counter(Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._vals: Dict[LabelKey, float] = {}

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        if not state.enabled():
            return
        key = _key(labels)
        with self._lock:
            self._vals[key] = self._vals.get(key, 0.0) + value

    def value(self, **labels: Any) -> float:
        return self._vals.get(_key(labels), 0.0)

    def total(self) -> float:
        return sum(self._vals.values())

    def label_sets(self) -> List[LabelKey]:
        return sorted(self._vals)

    def prometheus_lines(self) -> List[str]:
        return [f"{self.name}{_fmt_labels(k)} {_num(v)}"
                for k, v in sorted(self._vals.items())]

    def samples(self) -> List[dict]:
        return [dict(name=self.name, kind=self.kind, labels=dict(k), value=v)
                for k, v in sorted(self._vals.items())]

    def reset(self) -> None:
        with self._lock:
            self._vals.clear()


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        if not state.enabled():
            return
        with self._lock:
            self._vals[_key(labels)] = float(value)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # per label set: (bucket counts incl. +Inf, sum, count)
        self._vals: Dict[LabelKey, list] = {}

    def observe(self, value: float, **labels: Any) -> None:
        if not state.enabled():
            return
        key = _key(labels)
        with self._lock:
            st = self._vals.get(key)
            if st is None:
                st = self._vals[key] = [[0] * (len(self.buckets) + 1),
                                        0.0, 0]
            counts, _, _ = st
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            counts[-1] += 1                       # +Inf
            st[1] += float(value)
            st[2] += 1

    def count(self, **labels: Any) -> int:
        st = self._vals.get(_key(labels))
        return st[2] if st else 0

    def sum(self, **labels: Any) -> float:
        st = self._vals.get(_key(labels))
        return st[1] if st else 0.0

    def label_sets(self) -> List[LabelKey]:
        return sorted(self._vals)

    def prometheus_lines(self) -> List[str]:
        lines: List[str] = []
        for key, (counts, total, n) in sorted(self._vals.items()):
            for i, b in enumerate(self.buckets):
                le = dict(key)
                lab = _fmt_labels(_key({**le, "le": _num(b)}))
                lines.append(f"{self.name}_bucket{lab} {counts[i]}")
            lab = _fmt_labels(_key({**dict(key), "le": "+Inf"}))
            lines.append(f"{self.name}_bucket{lab} {counts[-1]}")
            lines.append(f"{self.name}_sum{_fmt_labels(key)} {_num(total)}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} {n}")
        return lines

    def samples(self) -> List[dict]:
        return [dict(name=self.name, kind=self.kind, labels=dict(k),
                     count=n, sum=total,
                     buckets={_num(b): c for b, c in
                              zip(self.buckets, counts)})
                for k, (counts, total, n) in sorted(self._vals.items())]

    def reset(self) -> None:
        with self._lock:
            self._vals.clear()


def _num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class Registry:
    """Get-or-create metric namespace with text/JSONL export."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get(self, cls, name: str, help: str, **kw: Any) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def reset(self) -> None:
        """Clear recorded values; registered metric objects (and the handles
        instrumented modules hold) stay valid."""
        for m in list(self._metrics.values()):
            m.reset()

    # ------------------------------------------------------------- exports
    def to_prometheus(self) -> str:
        out: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if not m.label_sets():
                continue
            if m.help:
                out.append(f"# HELP {name} {m.help}")
            out.append(f"# TYPE {name} {m.kind}")
            out.extend(m.prometheus_lines())
        return "\n".join(out) + ("\n" if out else "")

    def to_jsonl(self) -> str:
        lines = [json.dumps(s, sort_keys=True)
                 for name in sorted(self._metrics)
                 for s in self._metrics[name].samples()]
        return "\n".join(lines) + ("\n" if lines else "")

    def write_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus())

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    def snapshot(self) -> Dict[str, float]:
        """Flat ``{name{labels}: value}`` view — counters/gauges by value,
        histograms as ``_count``/``_sum`` — for BENCH-row embedding."""
        snap: Dict[str, float] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                for key, (_, total, n) in sorted(m._vals.items()):
                    lab = _fmt_labels(key)
                    snap[f"{name}_count{lab}"] = n
                    snap[f"{name}_sum{lab}"] = total
            elif isinstance(m, Counter):            # Gauge subclasses Counter
                for key, v in sorted(m._vals.items()):
                    snap[f"{name}{_fmt_labels(key)}"] = v
        return snap


#: the default process registry; module-level helpers below bind to it
REGISTRY = Registry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
to_prometheus = REGISTRY.to_prometheus
to_jsonl = REGISTRY.to_jsonl
write_prometheus = REGISTRY.write_prometheus
write_jsonl = REGISTRY.write_jsonl
snapshot = REGISTRY.snapshot
reset = REGISTRY.reset

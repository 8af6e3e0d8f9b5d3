"""Admission scheduling: FIFO slot assignment + ``DeadlineGate`` overload
shedding (the counterpart of ``repro.serve.scheduler``, with its obs gauge
``repro_sched_queue_depth`` and counter ``repro_sched_gate_shed_total``).

Under normal load the scheduler is plain FIFO: longest-waiting requests take
free slots first. With a gate configured, each queued request's wait plays
the role of a worker's arrival time at a sync point: requests whose wait
already exceeds ``deadline_s`` are dropped (``finish_reason="shed"``), but
never more than a ``1 - quorum`` fraction of the queue. The gate is
consulted on every non-empty round, light load included: an expired
request wastes a slot whether or not the queue outnumbers the free slots.
``now`` is taken by the engine at the start of the round.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, List, Optional, Tuple

from repro_torch import obs
from repro_torch.dist import DeadlineGate
from repro_torch.serve.api import Request

_M_QDEPTH = obs.gauge("repro_sched_queue_depth",
                      "queued requests at the start of each round")
_M_GATE_SHED = obs.counter("repro_sched_gate_shed_total",
                           "requests dropped by the deadline gate")


class Scheduler:
    """FIFO queue + gate-based overload shedding.

    gate=None disables shedding (pure FIFO backpressure: requests wait
    indefinitely for a slot).
    """

    def __init__(self, *, gate: Optional[DeadlineGate] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.gate = gate
        self.clock = clock
        self._q: deque = deque()

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, req: Request, now: Optional[float] = None) -> None:
        if req.arrival_s is None:
            req.arrival_s = self.clock() if now is None else now
        self._q.append(req)

    def schedule(self, free_slots: int,
                 now: Optional[float] = None
                 ) -> Tuple[List[Request], List[Request]]:
        """-> (admit, shed). ``admit`` fits in ``free_slots``; ``shed`` are
        expired requests dropped by the gate (empty without a gate). The
        gate runs whenever the queue is non-empty — light load included —
        so an abandoned request never spends a slot."""
        _M_QDEPTH.set(len(self._q))
        if not self._q:
            return [], []
        now = self.clock() if now is None else now
        cand = list(self._q)
        shed: List[Request] = []
        if self.gate is not None:
            waits = [now - r.arrival_s for r in cand]
            kept_idx, _ = self.gate.admit(waits)
            kept = set(kept_idx)
            shed = [r for i, r in enumerate(cand) if i not in kept]
            cand = [r for i, r in enumerate(cand) if i in kept]
            if shed:
                _M_GATE_SHED.inc(len(shed))
        # slot-cost-aware FIFO: an n>1 request consumes n slots (one per
        # fan-out stream) and admits atomically — all streams or none, since
        # the siblings must prefill in lockstep to share prompt pages.
        # Head-of-line blocking is deliberate: skipping past a too-wide
        # request would starve it under steady narrow traffic.
        free = max(free_slots, 0)
        admit: List[Request] = []
        used = 0
        for r in cand:
            cost = max(int(getattr(r, "n", 1) or 1), 1)
            if used + cost > free:
                break
            admit.append(r)
            used += cost
        keep_back = cand[len(admit):]
        self._q = deque(keep_back)
        return admit, shed

"""Straggler-quorum admission (the counterpart of ``DeadlineGate`` in
``repro.dist.fault_tolerance``, copied: that module imports JAX). The rest
of that module — ``TrainingRunner``, ``FailureSource`` — comes with
training."""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple


class DeadlineGate:
    """Straggler quorum admission (async-relaxation, arXiv:1712.06047 §4).

    Workers report arrival times for a sync point; the gate closes at
    ``deadline_s`` provided at least ``quorum`` (fraction) arrived, dropping
    stragglers from the collective. If the quorum itself is late, the gate
    stays open until the quorum-th arrival — correctness over latency.
    """

    def __init__(self, deadline_s: float, quorum: float = 0.75):
        if not 0.0 < quorum <= 1.0:
            raise ValueError(f"quorum must be in (0, 1], got {quorum}")
        self.deadline_s = float(deadline_s)
        self.quorum = float(quorum)

    def admit(self, arrivals: Sequence[float]) -> Tuple[List[int], float]:
        """-> (admitted worker indices, wall-clock wait before closing)."""
        n = len(arrivals)
        if n == 0:
            return [], 0.0
        need = max(int(math.ceil(self.quorum * n)), 1)
        within = [i for i, t in enumerate(arrivals) if t <= self.deadline_s]
        if len(within) >= need:
            if len(within) == n:  # everyone made it: close at last arrival
                return within, max(arrivals)
            return within, self.deadline_s
        # quorum missed the deadline: wait for the need-th arrival
        cutoff = sorted(arrivals)[need - 1]
        admitted = [i for i, t in enumerate(arrivals) if t <= cutoff]
        return admitted, cutoff

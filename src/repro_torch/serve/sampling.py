"""Per-request decode policy (the ``SamplingParams`` dataclass of
``repro.serve.sampling``, copied with its validation: that module imports
JAX). The engine serves greedy requests only; the in-block draws, the
per-slot keys and ``host_fold_in`` come with the rest of serving (ROADMAP
queue 1 item 8)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy.

    temperature: 0 (the default) is the greedy fast path — bit-identical to
    the argmax engine. > 0 samples from softmax(logits / temperature).
    top_p: nucleus mass; keep the minimal set of highest-probability tokens
    whose mass is >= top_p, renormalize, sample. 1.0 disables.
    top_k: keep only the k highest logits (0 disables).
    seed: stream seed. Two requests with the same seed and prompt produce
    the same tokens regardless of k, slot, or engine instance. None lets
    the engine draw a fresh seed at admission.
    """
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    seed: Optional[int] = None

    def __post_init__(self):
        # non-finite values must be rejected explicitly: every ordered
        # comparison against NaN is False, so ``temperature=float("nan")``
        # sails through the range checks below, reads as non-greedy, and
        # turns the scaled logits all-NaN at draw time
        if not math.isfinite(self.temperature) or self.temperature < 0.0:
            raise ValueError(
                f"temperature must be finite and >= 0, got {self.temperature}")
        if not math.isfinite(self.top_p) or not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be finite and in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()

"""The card's roofline: its peaks (:mod:`.hw`, the one home of every
bound's constants), the least time a registry op's call could take
(:func:`bound_ms`, from the op's work function in ``kernels.registry``),
and the three terms of a whole program (:mod:`.analysis`)."""
from __future__ import annotations

from typing import Tuple

from repro_torch.kernels.registry import Work
from repro_torch.roofline.analysis import (Roofline, StorageTracker, analyze,
                                           category, mfu, model_flops)
from repro_torch.roofline.hw import H100, Chip


def bound_ms(work: Work, chip: Chip = H100) -> Tuple[float, str]:
    """The least time ``chip`` could take for ``work``, in ms, and what
    bounds it: the larger of its bytes over HBM bandwidth and its FLOPs
    over the peak of its dtype ("bytes" or "operations")."""
    tb = work.bytes / chip.hbm_bw
    tf = work.flops / chip.peak(work.dtype)
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


__all__ = ["Chip", "H100", "Work", "bound_ms", "Roofline", "StorageTracker",
           "analyze", "category", "mfu", "model_flops"]

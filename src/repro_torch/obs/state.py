"""Global on/off switch for the observability layer (a copy of
``repro.obs.state``).

Everything in ``repro_torch.obs`` is built to cost nothing when disabled:
span constructors return a shared no-op context manager, metric mutations
early-return after one boolean check, and the sync auditor's torch patches
are only installed while an audit context is active. The switch is
process-wide (the launch CLIs flip it from ``--metrics``/``--trace-out``);
instrumented hot loops may additionally guard multi-call blocks with
``enabled()`` to pay the boolean once instead of per call.
"""
from __future__ import annotations

_enabled = False


def enable() -> None:
    """Turn span collection and metric recording on, process-wide."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn span collection and metric recording off (data is kept)."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled

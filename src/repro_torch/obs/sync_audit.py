"""Host<->device synchronization audit, on torch (the counterpart of
``repro.obs.sync_audit``, with its counting semantics).

``with sync_audit(device) as audit:`` counts the host-blocking device reads
the wrapped host code performs, by patching torch's and numpy's read entry
points for the duration of the context, plus the dispatches instrumented
call sites announce via :func:`mark_dispatch`. It is the empirical check of
the paper's CA-k claim: a CA solve makes one host round trip per k-block,
the k-step decode one per k steps, and the audit measures that at the torch
boundary instead of trusting the port's own ``HostSyncs.blocks`` or
``EngineStats.syncs``.

What counts as a read, of a tensor on the audited device:

* ``torch.cuda.synchronize`` and ``torch.cuda.Stream``/``Event``
  ``.synchronize`` — ``block_until_ready`` (a CUDA audit only);
  :func:`block_until_ready` is the port's device-neutral wait (the
  ``jax.block_until_ready`` of a host loop): ``torch.cuda.synchronize`` on a
  card, a counted read with nothing to wait for on the CPU;
* ``.cpu()`` and ``.to(<cpu>)`` that copy — ``device_get``;
* ``.item()``, ``.tolist()``, ``.numpy()``, ``__bool__``, ``__float__``,
  ``__int__`` and ``np.asarray``/``np.array`` — conversions.

Host data (numpy arrays, lists, tensors on another device) is never counted.
The audit takes its device explicitly, as every entry point of the port
does: ``cuda`` by default, or ``cpu``, where CPU tensors stand for the
device's. On the CPU ``.cpu()`` of a tensor is the tensor itself, so it
copies nothing and is not counted; reading it afterwards is. A host copy
made by a counted fetch (``.to("cpu", copy=True)``) is host data from then
on, views of it too. The same host loop thus shows the same epochs on both
devices.

Counting semantics (the paper's alpha-beta cost split), as in the JAX class:

* ``transfers`` counts every intercepted device read — the *words* side.
* ``syncs`` counts round-trip *epochs* — the latency (alpha) side, the term
  CA-k divides by k. Consecutive reads coalesce into one sync until a
  dispatch boundary (:func:`mark_dispatch`) closes the epoch.
* ``dispatches`` counts those announced dispatch boundaries.
* ``overlap_epochs`` counts *hidden* syncs: epochs whose reads fetch the
  results of a dispatch that is no longer the latest one (announced through
  :func:`mark_fetch` with a stale ticket).
* ``by_span`` attributes each sync to the innermost active
  :mod:`repro_torch.obs.spans` span at the moment it was counted.

The patches see Python calls only: a synchronizing op inside C++ (``nonzero``,
a boolean-mask index, a copy to the host through ``copy_``) is invisible to
them. A CUDA audit therefore also runs the CUDA runtime's own check,
``torch.cuda.set_sync_debug_mode("warn")``, records each warning it raises
(``runtime_syncs``) and those raised outside any counted read
(``runtime_uncounted``: hidden syncs the patches missed), and restores the
mode it found when the last audit exits.

Patches are installed when the first audit enters and removed when the last
exits — code outside any audit pays nothing. Nested audits each receive all
events of their device.
"""
from __future__ import annotations

import contextlib
import threading
import warnings
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs import spans

_audits: List["SyncAudit"] = []
_patch_lock = threading.Lock()
_saved: list = []                       # (holder, name, original or None)
_tls = threading.local()                # .in_read: reentrancy guard
_dispatch_seq = 0                       # monotonic mark_dispatch ticket
#: host copies made by counted fetches, by storage address (live ones only)
_host_copies: "weakref.WeakValueDictionary[int, torch.Tensor]" = \
    weakref.WeakValueDictionary()
_debug: dict = {}                       # saved sync-debug mode and warnings

#: the message of the CUDA runtime's sync-debug warning
_SYNC_WARNING = "called a synchronizing CUDA operation"
#: tensor methods that read a tensor's values on the host
_CONVERT = ("item", "tolist", "numpy", "__bool__", "__float__", "__int__")
#: numpy entry points that pull a tensor to the host
_NP_PATCHES = ("asarray", "array")


class SyncAudit:
    """Counters for one audited region (see module docstring)."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.syncs = 0              # coalesced round-trip epochs (alpha term)
        self.transfers = 0          # raw intercepted device reads (beta term)
        self.dispatches = 0         # mark_dispatch() boundaries
        self.overlap_epochs = 0     # hidden syncs (fetch of a stale ticket)
        self.block_until_ready = 0
        self.device_get = 0
        self.by_span: Dict[str, int] = {}
        #: the CUDA runtime's sync-debug warnings inside the audit, and
        #: those raised outside any counted read
        self.runtime_syncs = 0
        self.runtime_uncounted = 0
        self._epoch_open = False
        self._last_seq: Optional[int] = None    # latest dispatch ticket seen
        self._fetch_hidden = False              # next epoch is a hidden sync

    def _read(self, kind: str) -> None:
        self.transfers += 1
        if kind == "block_until_ready":
            self.block_until_ready += 1
        elif kind == "device_get":
            self.device_get += 1
        if not self._epoch_open:
            self._epoch_open = True
            self.syncs += 1
            if self._fetch_hidden:
                self.overlap_epochs += 1
                self._fetch_hidden = False
            name = spans.current()
            self.by_span[name] = self.by_span.get(name, 0) + 1

    def _dispatch(self, seq: int) -> None:
        self.dispatches += 1
        self._epoch_open = False
        self._last_seq = seq
        self._fetch_hidden = False  # a newer dispatch voids the announcement

    def _fetch(self, ticket: Optional[int]) -> None:
        # a fetch boundary is also an epoch boundary: reads coalesce only
        # within one dispatched computation's result set
        self._epoch_open = False
        # the next epoch is hidden iff it fetches results of a dispatch that
        # is no longer the latest: newer device work was already in flight
        self._fetch_hidden = (ticket is not None
                              and self._last_seq is not None
                              and ticket < self._last_seq)

    @property
    def blocking_syncs(self) -> int:
        """Epochs with nothing newer in flight — true pipeline stalls."""
        return self.syncs - self.overlap_epochs

    def as_dict(self) -> dict:
        return dict(syncs=self.syncs, transfers=self.transfers,
                    dispatches=self.dispatches,
                    overlap_epochs=self.overlap_epochs,
                    block_until_ready=self.block_until_ready,
                    device_get=self.device_get, by_span=dict(self.by_span))


def _count_read(kind: str, device_type: str) -> None:
    if not _audits or getattr(_tls, "in_read", False):
        return
    for a in _audits:
        if a.device.type == device_type:
            a._read(kind)


def _device_data(t) -> Optional[str]:
    """The device type a read of ``t`` counts against, or None for host
    data: non-tensors, and the host copies of counted fetches."""
    if not isinstance(t, torch.Tensor):
        return None
    dev = t.device.type
    if dev == "cpu" and _host_copies and \
            t.untyped_storage().data_ptr() in _host_copies:
        return None
    return dev


def mark_dispatch(site: str = "") -> int:
    """Announce a host->device dispatch boundary (closes the read epoch).

    Instrumented host loops call this immediately before enqueueing device
    work whose results they will fetch. Returns a monotonic ticket
    identifying the dispatch; a double-buffered loop hands the ticket to
    :func:`mark_fetch` when it later blocks on the results. Near-no-op (one
    integer increment + truthiness check) when no audit is active.
    """
    global _dispatch_seq
    _dispatch_seq += 1
    if _audits:
        for a in _audits:
            a._dispatch(_dispatch_seq)
    return _dispatch_seq


def mark_fetch(ticket: Optional[int] = None) -> None:
    """Announce that the upcoming device reads fetch the results of the
    dispatch identified by ``ticket`` (from :func:`mark_dispatch`); a stale
    ticket makes the epoch they open a hidden one. No-op when no audit is
    active."""
    if not _audits:
        return
    for a in _audits:
        a._fetch(ticket)


def block_until_ready(device) -> None:
    """Wait until the work queued on ``device`` is done, as a counted read:
    ``torch.cuda.synchronize`` on a card (counted by its patch); on the CPU
    the work is done when its call returns, and the read is counted
    here."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    else:
        _count_read("block_until_ready", device.type)


@contextlib.contextmanager
def _reentrancy_guard():
    prev = getattr(_tls, "in_read", False)
    _tls.in_read = True
    try:
        yield
    finally:
        _tls.in_read = prev


def _wrap_sync(orig):
    """``torch.cuda.synchronize`` and the Stream/Event methods."""
    def wrapper(*args, **kwargs):
        _count_read("block_until_ready", "cuda")
        with _reentrancy_guard():
            return orig(*args, **kwargs)
    wrapper.__wrapped__ = orig
    return wrapper


def _wrap_convert(orig):
    """A conversion method, or a numpy entry point (``Tensor.__array__``
    calls ``.numpy()``, which the guard keeps from counting twice)."""
    def wrapper(self, *args, **kwargs):
        dev = _device_data(self)
        if dev is None or getattr(_tls, "in_read", False):
            return orig(self, *args, **kwargs)
        _count_read("convert", dev)
        with _reentrancy_guard():
            return orig(self, *args, **kwargs)
    wrapper.__wrapped__ = orig
    return wrapper


def _wrap_fetch(orig, to_host):
    """``.cpu()`` / ``.to(...)``: a read iff it copies device data to the
    host; the copy is host data from then on."""
    def wrapper(self, *args, **kwargs):
        dev = _device_data(self)
        if dev is None or getattr(_tls, "in_read", False) or \
                not to_host(args, kwargs):
            return orig(self, *args, **kwargs)
        with _reentrancy_guard():
            out = orig(self, *args, **kwargs)
        if out is not self:
            _count_read("device_get", dev)
            if dev == "cpu":
                _host_copies[out.untyped_storage().data_ptr()] = out
        return out
    wrapper.__wrapped__ = orig
    return wrapper


def _cpu_target(args, kwargs) -> bool:
    return True


def _to_target(args, kwargs) -> bool:
    """Whether ``Tensor.to(*args, **kwargs)`` targets the host: a device (or
    a tensor, whose device) first, or ``device=``."""
    a = args[0] if args else kwargs.get("device", kwargs.get("other"))
    if isinstance(a, torch.Tensor):
        a = a.device
    return isinstance(a, (str, torch.device)) and torch.device(a).type == "cpu"


def _patch(holder, name: str, wrapped) -> None:
    _saved.append((holder, name, holder.__dict__.get(name)))
    setattr(holder, name, wrapped)


def _install() -> None:
    _patch(torch.cuda, "synchronize", _wrap_sync(torch.cuda.synchronize))
    for cls in (torch.cuda.Stream, torch.cuda.Event):
        _patch(cls, "synchronize", _wrap_sync(cls.synchronize))
    for name in _CONVERT:
        _patch(torch.Tensor, name, _wrap_convert(getattr(torch.Tensor, name)))
    _patch(torch.Tensor, "cpu", _wrap_fetch(torch.Tensor.cpu, _cpu_target))
    _patch(torch.Tensor, "to", _wrap_fetch(torch.Tensor.to, _to_target))
    for name in _NP_PATCHES:
        _patch(np, name, _wrap_convert(getattr(np, name)))


def _uninstall() -> None:
    if _debug:
        _debug_off()
    for holder, name, orig in reversed(_saved):
        if orig is None:
            delattr(holder, name)       # the method was inherited
        else:
            setattr(holder, name, orig)
    del _saved[:]
    _host_copies.clear()


def _debug_on() -> None:
    """Run the CUDA runtime's sync check in ``warn`` mode and count its
    warnings instead of printing them."""
    _debug["mode"] = torch.cuda.get_sync_debug_mode()
    _debug["warnings"] = catch = warnings.catch_warnings()
    catch.__enter__()                   # saves the filters and showwarning
    warnings.filterwarnings("always", message=_SYNC_WARNING)
    show_other = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if _SYNC_WARNING not in str(message):
            return show_other(message, category, filename, lineno, file,
                              line)
        counted = getattr(_tls, "in_read", False)
        for a in _audits:
            if a.device.type == "cuda":
                a.runtime_syncs += 1
                a.runtime_uncounted += not counted
    warnings.showwarning = show
    torch.cuda.set_sync_debug_mode("warn")


def _debug_off() -> None:
    torch.cuda.set_sync_debug_mode(_debug["mode"])
    _debug["warnings"].__exit__(None, None, None)
    _debug.clear()


@contextlib.contextmanager
def sync_audit(device="cuda"):
    """Audit host<->device syncs on ``device`` in the wrapped region (see
    module doc)."""
    audit = SyncAudit(device)
    with _patch_lock:
        _audits.append(audit)
        if len(_audits) == 1:
            _install()
        if audit.device.type == "cuda" and not _debug and \
                torch.cuda.is_available():
            _debug_on()
    try:
        yield audit
    finally:
        with _patch_lock:
            _audits.remove(audit)
            if not _audits:
                _uninstall()

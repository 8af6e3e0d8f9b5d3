"""Kernel registry of the port: one named-op table, one impl per backend.

The counterpart of ``repro.kernels.registry``, slimmed to what the port
runs. Each op registers two implementations:

* ``gram_gather``, ``prox_step_block``, ``prox_loop_block`` — the Lasso
  solvers' kernels (a k-block of FISTA or proximal Newton updates a
  dispatch), ``prox_step`` and ``prox_loop``, their one-step instances,
  and ``gram``, the Gram matrix of draws already gathered (the Pallas
  kernel's counterpart);
* ``flash_attention`` — the model's teacher-forced attention, (B, S, H, D),
  with its per-row lse on request (``return_lse=True``);
* ``flash_dq``, ``flash_dkv`` — its backward: dq, and dk/dv summed over
  each kv head's GQA group (``models.attention`` reaches all three through
  the autograd Function of ``kernels.flash_attention.ops``);
* ``paged_attention`` — single-query decode attention through a page table
  (its CUDA kernel is ``paged_decode``);
* ``ssd`` — the Mamba-2 chunked SSD scan, (Bt, S, H, P), with the
  per-chunk incoming states on request (``return_states=True``), and
  ``ssd_bwd``, its reverse scan (``models.ssm`` reaches both through the
  autograd Function of ``kernels.ssd.ops``).

The two implementations of each:

* ``cuda``  — the hand-written Hopper kernel (``repro_torch/csrc``);
* ``torch`` — the plain PyTorch version of the same function (``ref.py``).

Backend policy resolution order (first match wins):

1. the innermost active ``with registry.use("..."):`` context,
2. a process-wide :func:`set_backend` call,
3. the ``REPRO_TORCH_BACKEND`` environment variable,
4. ``auto``: ``cuda`` for CUDA tensors, ``torch`` for CPU tensors.

There is no silent fallback. A ``cuda`` impl, asked for or picked by
``auto``, that cannot run here (no card, a card that is not compute
capability 9.0, a failed build, CPU tensors) raises. The ``torch`` impl
runs on CPU tensors, or on CUDA tensors only when the caller asks for it
explicitly (``use("torch")``, :func:`set_backend` or the environment
variable) — as ``chip_smoke.py`` does to hold each kernel against its plain
version on the card.

Each op also registers one work function (:func:`register_work`), which
takes the op's arguments and gives the :class:`Work` of one call: the
FLOPs it must do, the HBM bytes it must move and the dtype whose peak
applies. ``repro_torch.roofline`` turns a ``Work`` into the least time
the card could take (``roofline.bound_ms``) and counts a registry op by
it when it analyses a program (``roofline.analyze`` opens
:func:`counting` around the program, and :func:`dispatch` tells its
counter which op runs, so the counter does not count the op's own aten
ops a second time).

A ``cuda`` impl called on ``FakeTensor`` arguments (``launch.dryrun``)
skips the process-level availability check and runs its wrapper, which
allocates as on the card and launches nothing (``_build.launch``); a real
CPU tensor still raises.

Observability (``repro_torch.obs``): ``repro_kernel_dispatch_total{op,
backend}`` counts dispatches beside :func:`dispatch_counts`, as the JAX
registry does. Its other two counters are not ported:
``repro_kernel_fallback_total``, because this registry never falls back
(it raises), so the counter could never move; and
``repro_autotune_lookup_total``, which comes with autotuning (ROADMAP
queue 1 item 9).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import _build

#: canonical backend names
BACKENDS = ("cuda", "torch")
ENV_VAR = "REPRO_TORCH_BACKEND"

#: modules whose import registers every op implementation (lazy, so the
#: registry has no import-time dependency on the kernels that import it)
_IMPL_MODULES = (
    "repro_torch.kernels.gram.ops",       # registers "gram", "gram_gather"
    # registers "prox_step", "prox_loop", "prox_step_block", "prox_loop_block"
    "repro_torch.kernels.prox_step.ops",
    # registers "flash_attention", "flash_dq", "flash_dkv", "paged_attention"
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.ssd.ops",        # registers "ssd", "ssd_bwd"
)


def _no_reason() -> Optional[str]:
    return None


def _any_args(*_args: Any, **_kw: Any) -> Optional[str]:
    return None


@dataclasses.dataclass(frozen=True)
class Work:
    """One call's work: the FLOPs it must do (over the visible pairs and
    valid rows only, the data it is given), the HBM bytes it must move
    (each input read once, each output written once) and the dtype whose
    peak rate bounds the FLOPs."""
    flops: float
    bytes: float
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class Impl:
    """One backend implementation of a registered op."""
    backend: str
    fn: Callable
    #: process-level capability: None when usable, else why not (checked at
    #: every dispatch, so a card that appears later is seen)
    unavailable: Callable[[], Optional[str]]
    #: per-call capability over the actual arguments: None, or why not
    rejects: Callable[..., Optional[str]]


_OPS: Dict[str, Dict[str, Impl]] = {}
_WORK: Dict[str, Callable[..., Work]] = {}
_loaded = False
_load_lock = threading.Lock()
_tls = threading.local()            # .stack: list[str]
_process_backend: Optional[str] = None
#: dispatches by (op, backend), counted whether or not obs is enabled
_DISPATCH: collections.Counter = collections.Counter()
#: the same count in the obs registry (a no-op while obs is disabled)
_M_DISPATCH = obs.counter("repro_kernel_dispatch_total",
                          "kernel dispatches by op and backend")


def _canon(name: str) -> str:
    low = str(name).lower()
    if low not in BACKENDS and low != "auto":
        raise ValueError(f"unknown backend {name!r}; expected one of "
                         f"{BACKENDS + ('auto',)}")
    return low


def register(op_name: str, backend: str, *,
             unavailable: Callable[[], Optional[str]] = _no_reason,
             rejects: Callable[..., Optional[str]] = _any_args):
    """Decorator: register ``fn`` as ``op_name``'s ``backend`` impl. All impls
    of one op share a call signature."""
    backend = _canon(backend)
    if backend == "auto":
        raise ValueError("register a concrete backend, not 'auto'")

    def deco(fn: Callable) -> Callable:
        _OPS.setdefault(op_name, {})[backend] = Impl(backend, fn, unavailable,
                                                     rejects)
        return fn
    return deco


def register_work(op_name: str):
    """Decorator: register ``fn`` as ``op_name``'s work function. It takes
    the op's call signature and returns the call's :class:`Work`."""
    def deco(fn: Callable[..., Work]) -> Callable[..., Work]:
        _WORK[op_name] = fn
        return fn
    return deco


def work(name: str, *args: Any, **kwargs: Any) -> Work:
    """The :class:`Work` of one call of op ``name`` on these arguments."""
    ensure_loaded()
    if name not in _WORK:
        raise KeyError(f"op {name!r} has no work function; registered: "
                       f"{sorted(_WORK)}")
    return _WORK[name](*args, **kwargs)


def work_functions() -> Dict[str, Callable[..., Work]]:
    """Every registered work function by op name."""
    ensure_loaded()
    return dict(_WORK)


def ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    with _load_lock:
        if not _loaded:
            for mod in _IMPL_MODULES:
                importlib.import_module(mod)
            _loaded = True


def ops() -> List[str]:
    """Sorted names of every registered op."""
    ensure_loaded()
    return sorted(_OPS)


def _impls(name: str) -> Dict[str, Impl]:
    ensure_loaded()
    if name not in _OPS:
        raise KeyError(f"unknown op {name!r}; registered: {sorted(_OPS)}")
    return _OPS[name]


# --------------------------------------------------------------------------
# backend policy
# --------------------------------------------------------------------------

def _stack() -> List[str]:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def set_backend(name: Optional[str]) -> None:
    """Set (or with ``None`` clear) the process-wide backend policy.
    Overrides ``REPRO_TORCH_BACKEND``; overridden by ``use(...)``."""
    global _process_backend
    _process_backend = _canon(name) if name is not None else None


def policy() -> str:
    """The active policy name, possibly ``"auto"``."""
    stack = _stack()
    if stack:
        return stack[-1]
    if _process_backend is not None:
        return _process_backend
    env = os.environ.get(ENV_VAR, "").strip()
    if env:
        return _canon(env)
    return "auto"


def resolved_backend(device: Optional[torch.device] = None) -> str:
    """The concrete backend the active policy selects for tensors on
    ``device`` (``auto``: ``cuda`` for a CUDA device, else ``torch``)."""
    p = policy()
    if p == "auto":
        return ("cuda" if device is not None
                and torch.device(device).type == "cuda" else "torch")
    return p


@contextlib.contextmanager
def use(backend: str):
    """Scoped backend override: ``with registry.use("torch"): ...``. Beats
    :func:`set_backend` and the environment; restores the previous policy
    on exit, also on exception."""
    stack = _stack()
    stack.append(_canon(backend))
    try:
        yield
    finally:
        stack.pop()


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def _device_of(args) -> Optional[torch.device]:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def select(name: str, *args: Any, **kwargs: Any) -> Impl:
    """The impl :func:`dispatch` runs for this call under the active policy.
    Raises when that impl cannot run; it never picks another."""
    impls = _impls(name)
    backend = resolved_backend(_device_of(args))
    impl = impls.get(backend)
    if impl is None:
        raise NotImplementedError(
            f"op {name!r}: no {backend!r} implementation "
            f"(registered: {sorted(impls)})")
    why = ((None if _build.is_fake(*args) else impl.unavailable())
           or impl.rejects(*args, **kwargs))
    if why:
        raise RuntimeError(f"op {name!r}: backend {backend!r} cannot run "
                           f"(policy={policy()!r}): {why}")
    return impl


def dispatch(name: str, *args: Any, **kwargs: Any) -> Any:
    """Run op ``name`` under the active backend policy."""
    impl = select(name, *args, **kwargs)
    _DISPATCH[(name, impl.backend)] += 1
    _M_DISPATCH.inc(op=name, backend=impl.backend)
    if _COUNTER is None:
        return impl.fn(*args, **kwargs)
    with _COUNTER.registry_op(name, args, kwargs):
        return impl.fn(*args, **kwargs)


#: the counter of the open :func:`counting`, or None
_COUNTER = None


@contextlib.contextmanager
def counting(counter):
    """While open, every dispatch runs inside ``counter.registry_op(name,
    args, kwargs)`` (``roofline.analyze``'s dispatch mode, which counts a
    registry op by its work function and not its aten ops). It is one
    flag for the process, not the thread: a backward's ops run on
    autograd's device threads. With none open, :func:`dispatch` reads the
    flag and calls the impl."""
    global _COUNTER
    outer, _COUNTER = _COUNTER, counter
    try:
        yield
    finally:
        _COUNTER = outer


def dispatch_counts() -> Dict[Tuple[str, str], int]:
    """Dispatches by (op, backend) since the last reset."""
    return dict(_DISPATCH)


def reset_dispatch_counts() -> None:
    _DISPATCH.clear()

"""Build the port's CUDA sources at first use and bind them with ctypes.

Each ``repro_torch/csrc/<stem>.cu`` has a plain C interface and becomes one
shared library, compiled by ``nvcc`` for ``sm_90a`` into
``build/repro_torch/<stem>-<hash>.so`` at the root of the checkout. The hash
covers the source, every header it includes from ``csrc/`` (``#include
"..."``, followed through the headers' own includes) and the flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it
is. ``nvcc``'s ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) is kept beside the library as
``<stem>-<hash>.log``.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises when that is not ``cudaSuccess``. Nothing here runs at
import: the tests import every module on hosts with no card and no nvcc.

The wrappers launch through :func:`launch`, the one point where a launch
can be skipped: for a ``FakeTensor`` (``launch.dryrun`` traces a step
with fake tensors, which stand for the card's, on a host with no card)
nothing is built or launched, while the wrapper allocates its outputs and
workspaces exactly as on the card. A real tensor always launches, or
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor

SOURCES = ("gram", "prox_step", "flash_attention", "ssd")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: compute capability every kernel is built for
CAPABILITY = (9, 0)

_LIBS: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def is_fake(*args) -> bool:
    """Whether any argument is a ``FakeTensor`` (a tensor with no memory,
    made under ``torch._subclasses.fake_tensor.FakeTensorMode``)."""
    for a in args:
        if isinstance(a, FakeTensor):
            return True
    return False


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` stands for a tensor on the card: a CUDA tensor, or a
    fake one on any device (the dry run makes its fake tensors on the CPU
    device: autograd over fake ``cuda`` tensors aborts in a build of
    PyTorch without CUDA)."""
    return t.device.type == "cuda" or is_fake(t)


def unavailable_reason() -> Optional[str]:
    """None when the ``cuda`` kernels can run in this process, else why not."""
    if not torch.cuda.is_available():
        return "no CUDA device (torch.cuda.is_available() is False)"
    cap = torch.cuda.get_device_capability()
    if cap != CAPABILITY:
        return (f"kernels are built for sm_90a and need compute capability "
                f"{CAPABILITY}; {torch.cuda.get_device_name()} has {cap}")
    return None


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(stem: str, csrc: Path = CSRC) -> list:
    """``<stem>.cu`` and every header of ``csrc`` it includes with quotes,
    directly or through another header, each once, in the order found."""
    found, todo = [], [csrc / f"{stem}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [csrc / m.decode() for m in _INCLUDE.findall(
            path.read_bytes())]
    return found


def _target(stem: str, csrc: Path = CSRC) -> Path:
    h = hashlib.sha256()
    for path in _sources(stem, csrc):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build(stems: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every stem whose library is missing, one ``nvcc`` per source,
    all started together. Returns seconds per stem (0.0 when it was already
    built). Raises with nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for stem in stems:
        out = _target(stem)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        log = out.with_suffix(".log").open("w")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        started[stem] = (proc, tmp, out, log, time.perf_counter())
    seconds = {stem: 0.0 for stem in stems}
    failed = []
    for stem, (proc, tmp, out, log, t0) in started.items():
        rc = proc.wait()
        log.close()
        seconds[stem] = time.perf_counter() - t0
        if rc != 0:
            failed.append((stem, rc, out.with_suffix(".log").read_text()))
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {stem} (exit {rc})\n{text}" for stem, rc, text in failed))
    return seconds


def build_log(stem: str) -> str:
    """nvcc's report for the current build of ``stem`` ('' if none)."""
    log = _target(stem).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(stem: str) -> ctypes.CDLL:
    """The loaded library for ``stem``, built first if needed."""
    with _lock:
        lib = _LIBS.get(stem)
        if lib is None:
            build([stem])
            lib = _LIBS[stem] = ctypes.CDLL(str(_target(stem)))
        return lib


def function(stem: str, name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C entry point ``name`` of ``stem``'s library, with its ``argtypes``
    set (``c_void_p`` for every pointer and the stream, or ctypes would cut
    them to 32 bits) and an ``int`` (cudaError_t) result."""
    fn = getattr(library(stem), name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def launch(stem: str, name: str, argtypes: Sequence, what: str,
           like: torch.Tensor, *args) -> bool:
    """Call C entry point ``name`` of ``stem``'s library with ``args`` and
    raise on a CUDA error (:func:`check`, naming ``what``). Returns True
    when it launched;
    False, with nothing built or called, when ``like`` (the call's first
    operand) is a ``FakeTensor``, whose pointers are all 0. The caller
    counts a launch only when this returns True."""
    if is_fake(like):
        return False
    check(stem, function(stem, name, argtypes)(*args), what)
    return True


def check(stem: str, err: int, what: str) -> None:
    """Raise when a C entry point of ``stem`` reports a CUDA error (every
    source exports ``cuda_error_string`` for the message)."""
    if err != 0:
        fn = library(stem).cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} ({fn(err).decode()})")


def stream_of(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s
    device, as an int for ``c_void_p`` (0 for a ``FakeTensor``)."""
    if is_fake(t):
        return 0
    return torch.cuda.current_stream(t.device).cuda_stream


def rejects_cpu(*args, **_kw) -> Optional[str]:
    """Per-call capability of every ``cuda`` impl: all tensor arguments on a
    CUDA device."""
    devices = {"cuda" if on_card(a) else a.device.type
               for a in args if isinstance(a, torch.Tensor)}
    if devices != {"cuda"}:
        return f"the CUDA kernel needs CUDA tensors, got {sorted(devices)}"
    return None


def require(t: torch.Tensor, name: str, what: str, ndim: int) -> None:
    """Validate one kernel operand before its pointer goes to C."""
    if not on_card(t):
        raise ValueError(f"{what}: {name} must be on a CUDA device, "
                         f"got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{what}: {name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: {name} must have {ndim} dims, "
                         f"got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")

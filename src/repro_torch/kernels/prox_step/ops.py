"""Ops ``prox_step`` and ``prox_loop``: fused proximal-gradient step(s)
against a sampled Gram matrix.

``cuda`` launches ``csrc/prox_step.cu`` (counterparts of the Pallas kernels
``repro.kernels.prox_step.kernel.prox_step`` / ``prox_loop``); ``torch`` is
``ref.py``. Both take ``(G, R, v, scal)`` with ``scal`` the (5,) float32
device tensor ``[t, lam, mu, lo, hi]`` (see :func:`prox_scalars`), the
``variant`` as a keyword, and for ``prox_loop`` the iteration count ``Q`` as
a keyword. Unlike the JAX wrappers there is no fallback above a size limit:
the CUDA ``prox_loop`` keeps G in shared memory while it fits and reads it
from global memory above that, so every d runs on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.prox_step import ref
from repro_torch.kernels.prox_step.ref import VARIANTS

_P = ctypes.c_void_p
_I = ctypes.c_int
_STEP_ARGS = [_P] * 5 + [_I, _I, _P]
_LOOP_ARGS = [_P] * 5 + [_I, _I, _I, _P]


def prox_scalars(t, lam, mu=0.0, lo=0.0, hi=0.0, *,
                 device=None) -> torch.Tensor:
    """The (5,) float32 tensor ``[t, lam, mu, lo, hi]`` the prox ops read.
    ``t`` may be a device scalar tensor; it is not read back to the host."""
    t = torch.as_tensor(t, dtype=torch.float32, device=device).reshape(1)
    rest = torch.tensor([lam, mu, lo, hi], dtype=torch.float32,
                        device=t.device)
    return torch.cat([t, rest])


def _operands(G, R, v, scal, what):
    _build.require(G, "G", what, 2)
    d = G.shape[0]
    if G.shape != (d, d):
        raise ValueError(f"{what}: G must be square, got {tuple(G.shape)}")
    for name, t, n in (("R", R, d), ("v", v, d), ("scal", scal, 5)):
        _build.require(t, name, what, 1)
        if t.shape[0] != n:
            raise ValueError(f"{what}: {name} must have {n} elements, "
                             f"got {t.shape[0]}")
    return d


def _variant_id(variant: str) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"unknown prox variant {variant!r}; expected one of "
                         f"{VARIANTS}")
    return VARIANTS.index(variant)


def prox_step_cuda(G, R, v, scal, *, variant="l1"):
    """prox(v - t (G v - R)) by the Hopper kernel."""
    vid = _variant_id(variant)
    d = _operands(G, R, v, scal, "prox_step")
    out = torch.empty_like(v)
    fn = _build.function("prox_step", "prox_step_f32", _STEP_ARGS)
    err = fn(G.data_ptr(), R.data_ptr(), v.data_ptr(), scal.data_ptr(),
             out.data_ptr(), d, vid, _build.stream_of(G))
    _build.check("prox_step", err, "prox_step")
    prox_step_cuda.launches += 1
    return out


def prox_loop_cuda(G, R, z0, scal, *, Q: int, variant="l1"):
    """Q warm-started prox-gradient iterations by the Hopper kernel, in one
    launch."""
    vid = _variant_id(variant)
    d = _operands(G, R, z0, scal, "prox_loop")
    if Q < 0:
        raise ValueError(f"prox_loop: Q must be >= 0, got {Q}")
    out = torch.empty_like(z0)
    fn = _build.function("prox_step", "prox_loop_f32", _LOOP_ARGS)
    err = fn(G.data_ptr(), R.data_ptr(), z0.data_ptr(), scal.data_ptr(),
             out.data_ptr(), d, int(Q), vid, _build.stream_of(G))
    _build.check("prox_step", err, "prox_loop")
    prox_loop_cuda.launches += 1
    return out


prox_step_cuda.launches = 0
prox_loop_cuda.launches = 0


def prox_loop_limits() -> tuple:
    """(largest d whose G prox_loop keeps in shared memory, largest d it takes
    at all) on the current card, from its opt-in shared-memory size."""
    lib = _build.library("prox_step")
    shared_d, max_d = lib.prox_loop_max_shared_d, lib.prox_loop_max_d
    shared_d.argtypes = max_d.argtypes = []
    shared_d.restype = max_d.restype = ctypes.c_int
    return shared_d(), max_d()


registry.register("prox_step", "cuda", unavailable=_build.unavailable_reason,
                  rejects=_build.rejects_cpu)(prox_step_cuda)
registry.register("prox_step", "torch")(ref.prox_step)
registry.register("prox_loop", "cuda", unavailable=_build.unavailable_reason,
                  rejects=_build.rejects_cpu)(prox_loop_cuda)
registry.register("prox_loop", "torch")(ref.prox_loop)

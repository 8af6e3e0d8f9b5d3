"""Ops ``prox_step``, ``prox_loop``, ``prox_step_block`` and
``prox_loop_block``: fused proximal-gradient updates against sampled Gram
matrices.

``cuda`` launches ``csrc/prox_step.cu`` (counterparts of the Pallas kernels
``repro.kernels.prox_step.kernel.prox_step`` / ``prox_loop``, and of the
``lax.scan`` that applies them k times a block); ``torch`` is ``ref.py``.
The block ops run a whole k-block of updates in one launch:
``prox_step_block(G, R, w_prev, w, scal, j0=, variant=)`` takes k FISTA
steps (the momentum from the iteration counter ``j0`` of the first) and
``prox_loop_block(G, R, z0, scal, Q=, variant=)`` k proximal Newton steps
of Q inner iterations; both return the k iterates W (k, d). ``prox_step``
(v given) and ``prox_loop`` are their k = 1 instances. ``scal`` is the
(5,) float32 device tensor ``[t, lam, mu, lo, hi]`` (see
:func:`prox_scalars`). Unlike the JAX wrappers there is no fallback above
a size limit. The kernels stage the G_i in shared memory while two fit
and read them from global memory above that (and at k = 1, and for a d^2
that is not a multiple of 4). The iterate always lives in shared memory,
and one CTA runs a call: d is bounded by the card's opt-in shared memory
(19,368 on an H100; :func:`prox_loop_limits`), and a larger d is refused,
not run elsewhere.
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
_STEP_BLOCK_ARGS = [_P] * 6 + [_I] * 4 + [_P]
_LOOP_BLOCK_ARGS = [_P] * 5 + [_I] * 4 + [_P]
_INT_MAX = 2 ** 31 - 1


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
    _check_d(d, G.device, what)
    return d


_MAX_D: dict = {}


def _check_d(d: int, device, what: str) -> None:
    """Refuse a d whose vectors do not fit the card's shared memory."""
    max_d = _MAX_D.get(device.index)
    if max_d is None:
        with torch.cuda.device(device):
            max_d = _MAX_D[device.index] = prox_loop_limits()[1]
    if d > max_d:
        raise ValueError(f"{what}: d={d} is above {max_d}, the largest d "
                         f"whose vectors fit this card's shared memory (the "
                         f"kernels keep the iterate there and run a call in "
                         f"one CTA)")


def _variant_id(variant: str) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"unknown prox variant {variant!r}; expected one of "
                         f"{VARIANTS}")
    return VARIANTS.index(variant)


def prox_step_cuda(G, R, v, scal, *, variant="l1"):
    """prox(v - t (G v - R)) by the Hopper kernel (``prox_step_block``'s
    body at k = 1, v as given)."""
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
    launch (``prox_loop_block`` at k = 1)."""
    if G.dim() != 2:
        raise ValueError(f"prox_loop: G must be (d, d), got {tuple(G.shape)}")
    W = _loop_block(G[None], R[None], z0, scal, Q, variant, "prox_loop")
    prox_loop_cuda.launches += 1
    return W[0]


def _block_operands(G, R, vectors, scal, what):
    """(k, d) of a block op's operands, their shapes checked first (so a
    wrong shape is named on any device), then each one's device, dtype and
    layout."""
    if G.dim() != 3 or G.shape[1] != G.shape[2] or G.shape[0] < 1:
        raise ValueError(f"{what}: G must be (k, d, d) with k >= 1, got "
                         f"{tuple(G.shape)}")
    k, d = G.shape[0], G.shape[1]
    shapes = [("R", R, (k, d))] + [(n, t, (d,)) for n, t in vectors] + [
        ("scal", scal, (5,))]
    for name, t, want in shapes:
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} must have shape {want}, got "
                             f"{tuple(t.shape)}")
    for name, t, _ in [("G", G, None)] + shapes:
        _build.require(t, name, what, t.dim())
    _check_d(d, G.device, what)
    return k, d


def prox_step_block_cuda(G, R, w_prev, w, scal, *, j0: int, variant="l1"):
    """k FISTA steps by the Hopper kernel, in one launch: step i
    extrapolates with the momentum of iteration ``j0 + i`` and updates
    against (G[i], R[i]). Returns the k iterates W (k, d)."""
    vid = _variant_id(variant)
    if not 0 <= j0 <= _INT_MAX - G.shape[0]:
        raise ValueError(f"prox_step_block: j0 must be in [0, 2^31 - 1 - "
                         f"k], got {j0}")
    k, d = _block_operands(G, R, (("w_prev", w_prev), ("w", w)), scal,
                           "prox_step_block")
    W = torch.empty(k, d, dtype=torch.float32, device=G.device)
    fn = _build.function("prox_step", "prox_step_block_f32", _STEP_BLOCK_ARGS)
    err = fn(G.data_ptr(), R.data_ptr(), w_prev.data_ptr(), w.data_ptr(),
             scal.data_ptr(), W.data_ptr(), d, k, int(j0), vid,
             _build.stream_of(G))
    _build.check("prox_step", err, "prox_step_block")
    prox_step_block_cuda.launches += 1
    return W


def _loop_block(G, R, z0, scal, Q, variant, what):
    """One launch of ``prox_loop_block_f32``, uncounted."""
    vid = _variant_id(variant)
    if Q < 0:
        raise ValueError(f"{what}: Q must be >= 0, got {Q}")
    k, d = _block_operands(G, R, (("z0", z0),), scal, what)
    W = torch.empty(k, d, dtype=torch.float32, device=G.device)
    fn = _build.function("prox_step", "prox_loop_block_f32", _LOOP_BLOCK_ARGS)
    err = fn(G.data_ptr(), R.data_ptr(), z0.data_ptr(), scal.data_ptr(),
             W.data_ptr(), d, k, int(Q), vid, _build.stream_of(G))
    _build.check("prox_step", err, what)
    return W


def prox_loop_block_cuda(G, R, z0, scal, *, Q: int, variant="l1"):
    """k proximal Newton steps of Q inner iterations each by the Hopper
    kernel, in one launch, step i warm-started at step i - 1's result and
    iterating against (G[i], R[i]). Returns the k iterates W (k, d)."""
    W = _loop_block(G, R, z0, scal, Q, variant, "prox_loop_block")
    prox_loop_block_cuda.launches += 1
    return W


prox_step_cuda.launches = 0
prox_loop_cuda.launches = 0
prox_step_block_cuda.launches = 0
prox_loop_block_cuda.launches = 0


def prox_loop_limits() -> tuple:
    """(largest d whose G_i go through the shared-memory ring when d^2 is a
    multiple of 4, largest d the kernels take at all) on the current card,
    from its opt-in shared-memory size."""
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
registry.register("prox_step_block", "cuda",
                  unavailable=_build.unavailable_reason,
                  rejects=_build.rejects_cpu)(prox_step_block_cuda)
registry.register("prox_step_block", "torch")(ref.prox_step_block)
registry.register("prox_loop_block", "cuda",
                  unavailable=_build.unavailable_reason,
                  rejects=_build.rejects_cpu)(prox_loop_block_cuda)
registry.register("prox_loop_block", "torch")(ref.prox_loop_block)

"""Ops ``prox_step``, ``prox_loop``, ``prox_step_block``,
``prox_loop_block`` and ``pdhg_block``: fused proximal-gradient and
primal-dual updates against sampled Gram matrices.

``cuda`` launches ``csrc/prox_step.cu`` (counterparts of the Pallas kernels
``repro.kernels.prox_step.kernel.prox_step`` / ``prox_loop``, and of the
``lax.scan`` that applies them k times a block); ``torch`` is ``ref.py``.
The block ops run a whole k-block of updates:
``prox_step_block(G, R, w_prev, w, scal, j0=, variant=)`` takes k FISTA
steps (the momentum from the iteration counter ``j0`` of the first),
``prox_loop_block(G, R, z0, scal, Q=, variant=)`` k proximal Newton steps
of Q inner iterations, both returning the k iterates W (k, d), and
``pdhg_block(G, R, w, u, scal, sigma, variant=)`` k PDHG steps, returning
W and the last dual iterate u. ``prox_step`` (v given) and ``prox_loop``
are their k = 1 instances. ``scal`` is the (5,) float32 device tensor
``[t, lam, mu, lo, hi]`` (see :func:`prox_scalars`), ``sigma`` PDHG's (1,)
dual step.

``prox_step_block`` and ``prox_loop_block`` below are the block ops as
the solves call them, differentiable: the registered op forward (the CUDA
block kernel on the card) and a backward by autograd over ``ref.py``'s
version on the saved inputs (:class:`RecomputeFn`), the JAX package's
recompute VJP (``repro.kernels.prox_step.ops._recompute_vjp``).

Two routes, chosen by d alone (:func:`rows_route`), so a block and its
k = 1 instance, CA and classical, take the same one and keep the same bits:
up to ``ROWS_ABOVE_D``, one CTA a block launch, the iterate in shared
memory (``*_block_kernel``); above it, the rows route
(:func:`prox_rows_cuda`): a grid of CTAs over row blocks of G_i, one launch
a dependent step. Unlike the JAX wrappers there is no fallback to a plain
version at any d.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import to_device
from repro_torch.kernels import _build, registry
from repro_torch.kernels.prox_step import ref
from repro_torch.kernels.prox_step.ref import VARIANTS

_P = ctypes.c_void_p
_I = ctypes.c_int
_STEP_ARGS = [_P] * 5 + [_I, _I, _P]
_STEP_BLOCK_ARGS = [_P] * 6 + [_I] * 4 + [_P]
_LOOP_BLOCK_ARGS = [_P] * 5 + [_I] * 4 + [_P]
_PDHG_BLOCK_ARGS = [_P] * 8 + [_I] * 3 + [_P]
_ROWS_STEP_ARGS = [_P] * 6 + [_I] * 5 + [_P]
_ROWS_LOOP_ARGS = [_P] * 6 + [_I] * 4 + [_P]
_ROWS_PDHG_ARGS = [_P] * 9 + [_I] * 3 + [_P]
_INT_MAX = 2 ** 31 - 1
#: the largest d a prox op runs in one CTA; above it the rows route runs.
#: From chip_smoke.py phase 6a's times of both routes on an H100 (PERF.md
#: section 6): the rows route is faster from here on.
ROWS_ABOVE_D = 256


def prox_scalars(t, lam, mu=0.0, lo=0.0, hi=0.0, *,
                 device=None) -> torch.Tensor:
    """The (5,) float32 tensor ``[t, lam, mu, lo, hi]`` the prox ops read.
    ``t`` may be a device scalar tensor; it is not read back to the host,
    and the host values go up without blocking it."""
    rest = torch.tensor([lam, mu, lo, hi], dtype=torch.float32)
    if not isinstance(t, torch.Tensor):
        return to_device(torch.cat([torch.tensor([t], dtype=torch.float32),
                                    rest]), device or "cpu")
    t = t.to(device=device or t.device, dtype=torch.float32).reshape(1)
    return torch.cat([t, to_device(rest, t.device)])


def _operands(G, R, v, scal, what):
    _build.require(G, "G", what, 2)
    d = G.shape[0]
    if G.shape != (d, d) or d < 1:
        raise ValueError(f"{what}: G must be square, got {tuple(G.shape)}")
    for name, t, n in (("R", R, d), ("v", v, d), ("scal", scal, 5)):
        _build.require(t, name, what, 1)
        if t.shape[0] != n:
            raise ValueError(f"{what}: {name} must have {n} elements, "
                             f"got {t.shape[0]}")
    return d


def rows_route(d: int) -> bool:
    """Whether a prox op at this d takes the rows route: d alone decides,
    so a block and its k = 1 instance take the same one. ``ROWS_ABOVE_D``
    lies below the one-CTA limit (19,368 on an H100; the card test and
    ``chip_smoke.py`` check it against :func:`prox_loop_limits`)."""
    return d > ROWS_ABOVE_D


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
    if rows_route(d):
        return prox_rows_cuda(G[None], R[None], v, scal, variant=variant)[0]
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
    G, R = G[None], R[None]
    if _loop_rows(G, R, z0, scal, Q, variant, "prox_loop"):
        return prox_rows_cuda(G, R, z0, scal, Q=Q, variant=variant)[0]
    W = _loop_block(G, R, z0, scal, Q, variant, "prox_loop")
    prox_loop_cuda.launches += 1
    return W[0]


def _block_operands(G, R, vectors, scal, what, extra=()):
    """(k, d) of a block op's operands, their shapes checked first (so a
    wrong shape is named on any device), then each one's device, dtype and
    layout. ``extra``: (name, tensor, shape) of further operands."""
    if G.dim() != 3 or G.shape[1] != G.shape[2] or G.shape[0] < 1:
        raise ValueError(f"{what}: G must be (k, d, d) with k >= 1, got "
                         f"{tuple(G.shape)}")
    if G.shape[1] < 1:
        raise ValueError(f"{what}: d must be >= 1, got G {tuple(G.shape)}")
    k, d = G.shape[0], G.shape[1]
    shapes = [("R", R, (k, d))] + [(n, t, (d,)) for n, t in vectors] + [
        ("scal", scal, (5,))] + list(extra)
    for name, t, want in shapes:
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} must have shape {want}, got "
                             f"{tuple(t.shape)}")
    for name, t, _ in [("G", G, None)] + shapes:
        _build.require(t, name, what, t.dim())
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
    if rows_route(d):
        return prox_rows_cuda(G, R, w, scal, w_prev=w_prev, j0=j0,
                              variant=variant)
    W = torch.empty(k, d, dtype=torch.float32, device=G.device)
    fn = _build.function("prox_step", "prox_step_block_f32", _STEP_BLOCK_ARGS)
    err = fn(G.data_ptr(), R.data_ptr(), w_prev.data_ptr(), w.data_ptr(),
             scal.data_ptr(), W.data_ptr(), d, k, int(j0), vid,
             _build.stream_of(G))
    _build.check("prox_step", err, "prox_step_block")
    prox_step_block_cuda.launches += 1
    return W


def _loop_rows(G, R, z0, scal, Q, variant, what) -> bool:
    """Validate a loop op's operands; whether it takes the rows route."""
    _variant_id(variant)
    if Q < 0:
        raise ValueError(f"{what}: Q must be >= 0, got {Q}")
    _, d = _block_operands(G, R, (("z0", z0),), scal, what)
    return rows_route(d)


def _loop_block(G, R, z0, scal, Q, variant, what):
    """One launch of ``prox_loop_block_f32`` (operands validated by
    :func:`_loop_rows`), uncounted."""
    k, d = G.shape[0], G.shape[1]
    W = torch.empty(k, d, dtype=torch.float32, device=G.device)
    fn = _build.function("prox_step", "prox_loop_block_f32", _LOOP_BLOCK_ARGS)
    err = fn(G.data_ptr(), R.data_ptr(), z0.data_ptr(), scal.data_ptr(),
             W.data_ptr(), d, k, int(Q), _variant_id(variant),
             _build.stream_of(G))
    _build.check("prox_step", err, what)
    return W


def prox_loop_block_cuda(G, R, z0, scal, *, Q: int, variant="l1"):
    """k proximal Newton steps of Q inner iterations each by the Hopper
    kernel, in one launch, step i warm-started at step i - 1's result and
    iterating against (G[i], R[i]). Returns the k iterates W (k, d)."""
    if _loop_rows(G, R, z0, scal, Q, variant, "prox_loop_block"):
        return prox_rows_cuda(G, R, z0, scal, Q=Q, variant=variant)
    W = _loop_block(G, R, z0, scal, Q, variant, "prox_loop_block")
    prox_loop_block_cuda.launches += 1
    return W


def pdhg_block_cuda(G, R, w, u, scal, sigma, *, variant="l1"):
    """k PDHG steps by the Hopper kernel, in one launch: step i against
    (G[i], R[i]), from the primal and dual iterates w and u, with the dual
    step ``sigma`` (a (1,) device tensor). Returns the k primal iterates W
    (k, d) and the last dual iterate (d,)."""
    vid = _variant_id(variant)
    k, d = _block_operands(G, R, (("w", w), ("u", u)), scal, "pdhg_block",
                           (("sigma", sigma, (1,)),))
    if rows_route(d):
        return prox_rows_cuda(G, R, w, scal, u=u, sigma=sigma,
                              variant=variant)
    W = torch.empty(k, d, dtype=torch.float32, device=G.device)
    u_out = torch.empty(d, dtype=torch.float32, device=G.device)
    fn = _build.function("prox_step", "pdhg_block_f32", _PDHG_BLOCK_ARGS)
    err = fn(G.data_ptr(), R.data_ptr(), w.data_ptr(), u.data_ptr(),
             scal.data_ptr(), sigma.data_ptr(), W.data_ptr(),
             u_out.data_ptr(), d, k, vid, _build.stream_of(G))
    _build.check("prox_step", err, "pdhg_block")
    pdhg_block_cuda.launches += 1
    return W, u_out


def prox_rows_cuda(G, R, x, scal, *, w_prev=None, j0=0, Q=None, u=None,
                   sigma=None, variant="l1"):
    """The rows route of every prox op (``prox_rows_kernel``), one launch a
    dependent step over a grid of CTAs, for the block wrappers above, which
    validate the operands first. By the keywords given:

    * ``w_prev`` and ``j0``: k FISTA steps from (w_prev, w = x), k
      launches; neither: k ISTA steps from x (``prox_step``'s k = 1
      instance: v = x as given);
    * ``Q``: k proximal Newton steps of Q from z0 = x, k Q launches (none
      at Q = 0: each step returns its warm start);
    * ``u`` and ``sigma``: k PDHG steps from (w = x, u), k launches;
      returns (W, u).

    Returns W (k, d). Adds one to its count a kernel launch."""
    k, d = G.shape[0], G.shape[1]
    vid = _variant_id(variant)
    dev, st = G.device, _build.stream_of(G)
    W = torch.empty(k, d, dtype=torch.float32, device=dev)
    if u is not None:
        u_out = torch.empty(d, dtype=torch.float32, device=dev)
        scratch = torch.empty(2 * d, dtype=torch.float32, device=dev)
        fn = _build.function("prox_step", "prox_rows_pdhg_f32",
                             _ROWS_PDHG_ARGS)
        err = fn(G.data_ptr(), R.data_ptr(), x.data_ptr(), u.data_ptr(),
                 scal.data_ptr(), sigma.data_ptr(), W.data_ptr(),
                 u_out.data_ptr(), scratch.data_ptr(), d, k, vid, st)
        launches, result = k, (W, u_out)
    elif Q is not None:
        scratch = torch.empty(2 * d, dtype=torch.float32, device=dev)
        fn = _build.function("prox_step", "prox_rows_loop_f32",
                             _ROWS_LOOP_ARGS)
        err = fn(G.data_ptr(), R.data_ptr(), x.data_ptr(), scal.data_ptr(),
                 W.data_ptr(), scratch.data_ptr(), d, k, int(Q), vid, st)
        launches, result = k * Q, W
    else:
        on = w_prev is not None
        fn = _build.function("prox_step", "prox_rows_step_f32",
                             _ROWS_STEP_ARGS)
        err = fn(G.data_ptr(), R.data_ptr(),
                 (w_prev if on else x).data_ptr(), x.data_ptr(),
                 scal.data_ptr(), W.data_ptr(), d, k, int(j0), int(on), vid,
                 st)
        launches, result = k, W
    _build.check("prox_step", err, "prox_rows")
    prox_rows_cuda.launches += launches
    return result


prox_step_cuda.launches = 0
prox_loop_cuda.launches = 0
prox_step_block_cuda.launches = 0
prox_loop_block_cuda.launches = 0
pdhg_block_cuda.launches = 0
prox_rows_cuda.launches = 0


def prox_loop_limits() -> tuple:
    """(largest d whose G_i go through the shared-memory ring when d^2 is a
    multiple of 4, largest d the kernels take at all) on the current card,
    from its opt-in shared-memory size."""
    lib = _build.library("prox_step")
    shared_d, max_d = lib.prox_loop_max_shared_d, lib.prox_loop_max_d
    shared_d.argtypes = max_d.argtypes = []
    shared_d.restype = max_d.restype = ctypes.c_int
    return shared_d(), max_d()


class RecomputeFn(torch.autograd.Function):
    """Forward: the registered op ``name`` under the active policy.
    Backward: autograd over ``ref_fn`` on the saved inputs (prox
    subgradient semantics, as JAX's ``_recompute_vjp``); inputs that need
    no grad get None."""

    @staticmethod
    def forward(ctx, name, ref_fn, kw, *inputs):
        ctx.ref_fn, ctx.kw = ref_fn, kw
        ctx.save_for_backward(*inputs)
        return registry.dispatch(name, *inputs, **kw)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[3:])]
        wrt = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = ctx.ref_fn(*inputs, **ctx.kw)
        grads = iter(torch.autograd.grad(out, wrt, g.to(out.dtype),
                                         allow_unused=True))
        return (None, None, None) + tuple(
            next(grads) if t.requires_grad else None for t in inputs)


def _differentiable(name, ref_fn, kw, *inputs):
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return RecomputeFn.apply(name, ref_fn, kw, *inputs)
    return registry.dispatch(name, *inputs, **kw)


def prox_step_block(G, R, w_prev, w, scal, *, j0: int, variant="l1"):
    """The op ``prox_step_block`` (k FISTA steps a dispatch), with the
    recompute backward when an input needs grad."""
    return _differentiable("prox_step_block", ref.prox_step_block,
                           dict(j0=j0, variant=variant), G, R, w_prev, w,
                           scal)


def prox_loop_block(G, R, z0, scal, *, Q: int, variant="l1"):
    """The op ``prox_loop_block`` (k proximal Newton steps a dispatch), with
    the recompute backward when an input needs grad."""
    return _differentiable("prox_loop_block", ref.prox_loop_block,
                           dict(Q=Q, variant=variant), G, R, z0, scal)


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
registry.register("pdhg_block", "cuda", unavailable=_build.unavailable_reason,
                  rejects=_build.rejects_cpu)(pdhg_block_cuda)
registry.register("pdhg_block", "torch")(ref.pdhg_block)

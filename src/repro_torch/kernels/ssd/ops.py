"""Ops ``ssd`` and ``ssd_bwd``: the Mamba-2 SSD scan and its reverse scan,
in the model's layout, and :func:`ssd`, the differentiable scan the model
calls (the counterpart of ``repro.kernels.ssd.ops``).

``cuda`` launches ``csrc/ssd.cu``: ``ssd_fwd`` (counterpart of the Pallas
kernel ``repro.kernels.ssd.kernel.ssd``, with the per-chunk incoming states
on request) and ``ssd_bwd`` (counterpart of ``backward.ssd_bwd``); ``torch``
is ``ref.py``. The JAX wrapper transposes x dt and dt A to (Bt, H, S, ·)
float32 and pads S to a chunk multiple before its kernel; here the kernels
read x (strided), dt, A, B and C as the model holds them, form x dt and
dt A themselves and mask the ragged last chunk, so there is no copy and no
pad pass.

The operand types choose the body: x, B and C all bf16 (mamba2 hands the
conv's bf16 B and C as they are) run the tensor-core bodies
(``ssd_fwd_bf16_kernel``, ``ssd_bwd_bf16_kernel``), which read x, B, C and
dy through TMA and so need 16-byte aligned bases and strides; a float32 x,
B or C runs the CUDA-core bodies (``ssd_fwd_f32_kernel``,
``ssd_bwd_f32_kernel``). B and C come in float32 or in x's dtype.

Each CUDA wrapper counts its launches in a plain-integer ``launches``
attribute, ``ssd_cuda.launches`` (with or without the states) and
``ssd_bwd_cuda.launches``, and each body its own in ``launches_bf16`` and
``launches_f32`` beside it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.ssd import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGS = [_P] * 8 + [_I] * 7 + [_P, _P]
_BWD_ARGS = [_P] * 12 + [_I] * 7 + [_P, _P]
DEFAULT_CHUNK = 64
#: (chunk L, head dim P, state N) the kernels are instantiated for:
#: mamba2-780m's head, zamba2's and the smoke config's, at chunks of 32 and
#: 64. At L = 128 (P = 64, N = 128) the tiles would need 266 KB (forward)
#: and 468 KB (backward) of shared memory, past the H100's 227 KB a block.
SHAPES = frozenset((L, P, N) for L in (32, 64)
                   for P, N in ((64, 128), (64, 64), (16, 16)))
_TYPE = {torch.float32: 0, torch.bfloat16: 1}
#: the C side's body code when x, B and C are all bf16: the tensor cores
_TC = 2


def _check(t: torch.Tensor, name: str, what: str, shape, dtypes) -> None:
    """dtype, shape and a unit last stride of one operand (its device is
    checked once every operand's type is, by :func:`_check_devices`)."""
    if t.dtype not in dtypes:
        raise ValueError(f"{what}: {name} must be one of "
                         f"{[str(d) for d in dtypes]}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.dim() and t.stride(-1) != 1:
        raise ValueError(f"{what}: {name} needs a unit stride on its last "
                         f"dim, got strides {t.stride()}")


def _check_devices(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"{what}: {name} must be on a CUDA device, "
                             f"got {t.device}")


def _check_inputs(x, dt, A, B, C, chunk: int, what: str):
    """Validate the model-layout operands; returns (Bt, S, H, P, N)."""
    if x.dim() != 4 or B.dim() != 3:
        raise ValueError(f"{what}: x must be (Bt, S, H, P) and B, C (Bt, S, "
                         f"N), got {tuple(x.shape)} and {tuple(B.shape)}")
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    f32 = (torch.float32,)
    _check(x, "x", what, (Bt, S, H, P), tuple(_TYPE))
    _check(dt, "dt", what, (Bt, S, H), f32)
    _check(A, "A", what, (H,), f32)
    bc = tuple(dict.fromkeys((torch.float32, x.dtype)))
    _check(B, "B", what, (Bt, S, N), bc)
    _check(C, "C", what, (Bt, S, N), bc)
    if B.dtype != C.dtype:
        raise ValueError(f"{what}: B and C must share a dtype, got "
                         f"{B.dtype} and {C.dtype}")
    if (chunk, P, N) not in SHAPES:
        raise ValueError(f"{what}: (chunk, head dim, state) = "
                         f"{(chunk, P, N)} not among the built "
                         f"{sorted(SHAPES)}")
    if min(Bt, S, H) < 1 or Bt > 65535 or H > 2 ** 31 - 1:
        raise ValueError(f"{what}: unsupported shape x {tuple(x.shape)}")
    _check_devices(what, x=x, dt=dt, A=A, B=B, C=C)
    return Bt, S, H, P, N


def _body(x, B, C, what: str, *tma) -> int:
    """The C side's body code: the tensor cores when x, B and C are all
    bf16, whose operands (x, B, C and the backward's dy) TMA reads, so
    their bases and strides must be 16-byte aligned; else x's CUDA-core
    code."""
    if not all(t.dtype == torch.bfloat16 for t in (x, B, C)):
        return _TYPE[x.dtype]
    for t in (x, B, C, *tma):
        if t.data_ptr() % 16 or any(st * 2 % 16 for st, n in zip(
                t.stride()[:-1], t.shape[:-1]) if n > 1):
            raise ValueError(f"{what}: bf16 x, B, C and dy are read by TMA: "
                             f"rows must be 16-byte aligned, got strides "
                             f"{t.stride()} at offset {t.data_ptr() % 16}")
    return _TC


def _count(fn, body: int) -> None:
    """One launch of ``fn``'s kernel, by the body that ran it."""
    fn.launches += 1
    if body == _TC:
        fn.launches_bf16 += 1
    else:
        fn.launches_f32 += 1


def _strides(*pairs) -> ctypes.Array:
    """The leading strides of each (tensor, count), for the C side."""
    flat = [s for t, n in pairs for s in t.stride()[:n]]
    return (ctypes.c_int64 * len(flat))(*flat)


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *,
             chunk: int = DEFAULT_CHUNK, h0: Optional[torch.Tensor] = None,
             return_states: bool = False):
    """The SSD scan from zero state by the Hopper kernel. x (Bt,S,H,P)
    float32 or bf16, unit stride on P; dt (Bt,S,H), A (H,) float32; B and
    C (Bt,S,N) float32 or in x's dtype, unit last strides -> y (Bt,S,H,P)
    in x's dtype,
    h_final (Bt,H,P,N) float32 and, with ``return_states``, the state
    entering each chunk (Bt,H,ceil(S/chunk),P,N) float32."""
    what = "ssd"
    if h0 is not None:
        raise ValueError(f"{what}: the kernel starts from zero state; the "
                         f"plain version (backend torch) takes h0")
    Bt, S, H, P, N = _check_inputs(x, dt, A, B, C, chunk, what)
    body = _body(x, B, C, what)
    dev = x.device
    y = torch.empty(Bt, S, H, P, dtype=x.dtype, device=dev)
    h = torch.empty(Bt, H, P, N, dtype=torch.float32, device=dev)
    nc = -(-S // chunk)
    states = (torch.empty(Bt, H, nc, P, N, dtype=torch.float32, device=dev)
              if return_states else None)
    strides = _strides((x, 3), (dt, 2), (B, 2), (C, 2))
    fn = _build.function("ssd", "ssd_fwd", _FWD_ARGS)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), y.data_ptr(), h.data_ptr(),
             states.data_ptr() if return_states else None, body,
             Bt, S, H, P, N, chunk, ctypes.cast(strides, ctypes.c_void_p),
             _build.stream_of(x))
    _build.check("ssd", err, what)
    _count(ssd_cuda, body)
    return (y, h, states) if return_states else (y, h)


ssd_cuda.launches = ssd_cuda.launches_bf16 = ssd_cuda.launches_f32 = 0


def ssd_bwd_cuda(x, dt, A, B, C, dy, states, dh_final=None, *,
                 chunk: int = DEFAULT_CHUNK):
    """The reverse chunk scan by the Hopper kernel: the forward's operands,
    dy (Bt,S,H,P) in x's dtype (unit stride on P), the forward's states
    (Bt,H,nc,P,N) and dh_final (Bt,H,P,N) float32 contiguous (None:
    zeros) -> dxdt (Bt,S,H,P), da (Bt,S,H), and dB and dC per head
    (Bt,S,H,N), all float32."""
    what = "ssd_bwd"
    Bt, S, H, P, N = _check_inputs(x, dt, A, B, C, chunk, what)
    nc = -(-S // chunk)
    _check(dy, "dy", what, (Bt, S, H, P), (x.dtype,))
    for name, t, shape in (("states", states, (Bt, H, nc, P, N)),
                           ("dh_final", dh_final, (Bt, H, P, N))):
        if t is None and name == "dh_final":
            continue
        _check(t, name, what, shape, (torch.float32,))
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    _check_devices(what, dy=dy, states=states, dh_final=dh_final)
    body = _body(x, B, C, what, dy)
    dev = x.device
    dxdt = torch.empty(Bt, S, H, P, dtype=torch.float32, device=dev)
    da = torch.empty(Bt, S, H, dtype=torch.float32, device=dev)
    dB = torch.empty(Bt, S, H, N, dtype=torch.float32, device=dev)
    dC = torch.empty_like(dB)
    strides = _strides((x, 3), (dt, 2), (B, 2), (C, 2), (dy, 3))
    fn = _build.function("ssd", "ssd_bwd", _BWD_ARGS)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), dy.data_ptr(), states.data_ptr(),
             dh_final.data_ptr() if dh_final is not None else None,
             dxdt.data_ptr(), da.data_ptr(), dB.data_ptr(), dC.data_ptr(),
             body, Bt, S, H, P, N, chunk,
             ctypes.cast(strides, ctypes.c_void_p), _build.stream_of(x))
    _build.check("ssd", err, what)
    _count(ssd_bwd_cuda, body)
    return dxdt, da, dB, dC


ssd_bwd_cuda.launches = ssd_bwd_cuda.launches_bf16 = 0
ssd_bwd_cuda.launches_f32 = 0


def _rejects(x, dt, A, B, C, *rest, chunk: int = DEFAULT_CHUNK, h0=None,
             **_kw) -> Optional[str]:
    """Per-call capability of both ``cuda`` impls."""
    why = _build.rejects_cpu(x, dt, A, B, C, *rest)
    if why:
        return why
    if h0 is not None:
        return ("the kernel starts from zero state; an initial state h0 "
                "runs on the plain version (backend torch)")
    shape = (chunk, x.shape[-1], B.shape[-1])
    if shape not in SHAPES:
        return (f"(chunk, head dim, state) = {shape} not among the built "
                f"{sorted(SHAPES)}")
    return None


class SSDFn(torch.autograd.Function):
    """The SSD scan with the reverse-scan backward, the counterpart of the
    JAX package's ``custom_vjp`` (``_ssd_pallas_fwd``/``_bwd`` in
    ``repro.kernels.ssd.ops``): the forward runs the ``ssd`` op and saves
    its primal inputs only; the backward reruns ``ssd`` for the per-chunk
    states, runs ``ssd_bwd``, and chains its outputs through xdt = x dt
    and a = dt A to dx, ddt, dA, and through the head sum to dB and dC.
    Every op dispatches under the backend resolved when the forward ran
    (autograd may run the backward on its own thread, out of reach of a
    caller's ``registry.use``). The cotangent of a final state nobody used
    arrives as None and counts as zeros."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk, backend):
        with registry.use(backend):
            y, h = registry.dispatch("ssd", x, dt, A, B, C, chunk=chunk)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk, ctx.backend = chunk, backend
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, B, C = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        else:
            dy = dy.contiguous()
        if dh is not None:
            dh = dh.float().contiguous()
        with registry.use(ctx.backend):
            _, _, states = registry.dispatch("ssd", x, dt, A, B, C,
                                             chunk=ctx.chunk,
                                             return_states=True)
            dxdt, da, dBh, dCh = registry.dispatch(
                "ssd_bwd", x, dt, A, B, C, dy, states, dh, chunk=ctx.chunk)
        dt32 = dt.float()
        dx = (dxdt * dt32[..., None]).to(x.dtype)
        ddt = ((dxdt * x.float()).sum(-1) + da * A.float()).to(dt.dtype)
        dA = (da * dt32).sum((0, 1)).to(A.dtype)
        return (dx, ddt, dA, dBh.sum(2).to(B.dtype), dCh.sum(2).to(C.dtype),
                None, None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, *, chunk: Optional[int] = None,
        h0: Optional[torch.Tensor] = None):
    """Mamba-2 SSD: x (Bt,S,H,P); dt (Bt,S,H); A (H,); B, C (Bt,S,N) ->
    y (Bt,S,H,P) in x's dtype, h_final (Bt,H,P,N) float32. With grad
    enabled and an input that requires it, :class:`SSDFn`; otherwise the
    ``ssd`` op, as inference launches it. An initial state ``h0`` runs on
    the plain version (the kernel rejects it, as the Pallas path does)."""
    chunk = chunk or DEFAULT_CHUNK
    if h0 is None and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        return SSDFn.apply(x, dt, A, B, C, chunk,
                           registry.resolved_backend(x.device))
    return registry.dispatch("ssd", x, dt, A, B, C, chunk=chunk, h0=h0)


def ssd_decode_step(x_t, dt_t, A, B_t, C_t, h):
    """One-token SSD step, O(1) in the context: x_t (Bt,H,P); dt_t (Bt,H);
    B_t, C_t (Bt,N); h (Bt,H,P,N) float32 -> y_t (Bt,H,P) in x_t's dtype
    and the new h (the plain recurrence; it has no kernel in either
    package)."""
    decay = torch.exp(dt_t * A[None, :])                        # (Bt,H)
    upd = (dt_t[..., None] * x_t)[..., None] * B_t[:, None, None, :]
    h = decay[..., None, None] * h + upd
    y = torch.einsum("bhpn,bn->bhp", h, C_t)
    return y.to(x_t.dtype), h


registry.register("ssd", "cuda", unavailable=_build.unavailable_reason,
                  rejects=_rejects)(ssd_cuda)
registry.register("ssd", "torch")(ref.ssd_chunked)
registry.register("ssd_bwd", "cuda", unavailable=_build.unavailable_reason,
                  rejects=_rejects)(ssd_bwd_cuda)
registry.register("ssd_bwd", "torch")(ref.ssd_bwd)

"""Op ``gram``: G = Xs Xs^T for one draw (d, m) or a batch of draws (k, d, m).

``cuda`` launches ``csrc/gram.cu`` (counterpart of the Pallas kernel
``repro.kernels.gram.kernel.gram``); ``torch`` is :func:`ref.gram`. The
kernel splits the m axis into chunks fixed by m alone (:func:`chunking`),
writes one partial tile per chunk into scratch the wrapper allocates, and
sums the partials in chunk order — so a draw's G has the same bits at any
batch size k.

:func:`gram` is the differentiable form the solvers call: under autograd it
runs :class:`GramFn`, whose backward is the analytic VJP of the JAX
package's Pallas impl (``repro.kernels.gram.ops._gram_bwd``), dXs =
(dG + dG^T) Xs — a plain product outside any kernel, as in JAX.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.gram import ref

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
#: columns staged per step in the kernel (``KC`` in gram.cu)
_KC = 32
_MAX_CHUNKS = 128
_MIN_CHUNK = 512


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def chunking(m: int) -> Tuple[int, int]:
    """(chunk, nchunks) of the m axis: at most 128 chunks of at least 512
    columns each where m allows, chunk a multiple of 32. A function of m
    alone, never of the batch size or the card."""
    n = min(_cdiv(m, _MIN_CHUNK), _MAX_CHUNKS)
    chunk = _cdiv(_cdiv(m, n), _KC) * _KC
    return chunk, _cdiv(m, chunk)


def gram_cuda(Xs: torch.Tensor) -> torch.Tensor:
    """G = Xs Xs^T by the Hopper kernel; Xs float32, contiguous, on the card."""
    X3 = Xs.unsqueeze(0) if Xs.dim() == 2 else Xs
    _build.require(X3, "Xs", "gram", 3)
    k, d, m = X3.shape
    if min(k, d, m) < 1 or k > 65535:
        raise ValueError(f"gram: need 1 <= k <= 65535 and d, m >= 1, "
                         f"got shape {tuple(Xs.shape)}")
    chunk, nchunks = chunking(m)
    part = torch.empty(k * nchunks * d * d, dtype=torch.float32,
                       device=X3.device)
    G = torch.empty(k, d, d, dtype=torch.float32, device=X3.device)
    fn = _build.function("gram", "gram_f32", _ARGS)
    err = fn(X3.data_ptr(), part.data_ptr(), G.data_ptr(), k, d, m, chunk,
             nchunks, _build.stream_of(X3))
    _build.check("gram", err, "gram")
    gram_cuda.launches += 1
    return G if Xs.dim() == 3 else G[0]


gram_cuda.launches = 0


class GramFn(torch.autograd.Function):
    """G = Xs Xs^T through the ``gram`` op, with dXs = (dG + dG^T) Xs. The
    op dispatches under the backend resolved when the forward ran."""

    @staticmethod
    def forward(ctx, Xs, backend):
        with registry.use(backend):
            G = registry.dispatch("gram", Xs)
        ctx.save_for_backward(Xs)
        return G

    @staticmethod
    def backward(ctx, dG):
        Xs, = ctx.saved_tensors
        dG = dG.float()
        dXs = torch.matmul(dG + dG.transpose(-1, -2), Xs.float())
        return dXs.to(Xs.dtype), None


def gram(Xs: torch.Tensor) -> torch.Tensor:
    """G = Xs Xs^T for (d, m) or (k, d, m): :class:`GramFn` when grad is
    enabled and Xs requires it, else the ``gram`` op as it is."""
    if torch.is_grad_enabled() and Xs.requires_grad:
        return GramFn.apply(Xs, registry.resolved_backend(Xs.device))
    return registry.dispatch("gram", Xs)

registry.register("gram", "cuda", unavailable=_build.unavailable_reason,
                  rejects=_build.rejects_cpu)(gram_cuda)
registry.register("gram", "torch")(ref.gram)

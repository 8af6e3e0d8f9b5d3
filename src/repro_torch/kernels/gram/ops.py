"""Ops ``gram`` and ``gram_gather``: sampled Gram matrices.

``gram``: G = Xs Xs^T for one draw (d, m) or a batch of draws (k, d, m)
already gathered. ``cuda`` launches ``csrc/gram.cu`` (counterpart of the
Pallas kernel ``repro.kernels.gram.kernel.gram``); ``torch`` is
:func:`ref.gram`.

``gram_gather``: the same over the draws idx (k, m) of a sample-major copy
of the data, Xy_rows (n, r_pad), read in place by the kernel, scaled by
inv_m and split into G (k, r-1, r-1) and R (k, r-1), R the last column: the
Lasso solvers' block statistics in one launch pair, optionally into one
flat buffer ``out`` (G, then R) that a distributed solve all-reduces in one
collective. ``torch`` is :func:`ref.gram_gather`.

Both kernels split the m axis into chunks fixed by m alone
(:func:`chunking`), write one partial triangle per chunk into scratch the
wrapper allocates, and sum the partials in chunk order — so a draw's G has
the same bits at any batch size k, and ``gram_gather``'s G and R are
bitwise ``gram``'s over the gathered copy (before scaling).

:func:`gram` is the ``gram`` op's differentiable form: under autograd it
runs :class:`GramFn`, whose backward is the analytic VJP of the JAX
package's Pallas impl (``repro.kernels.gram.ops._gram_bwd``), dXs =
(dG + dG^T) Xs — a plain product outside any kernel, as in JAX.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.gram import ref

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
_GATHER_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 6
                + [ctypes.c_float, ctypes.c_void_p])
#: samples a stage holds in the kernels (``KC`` in gram.cu)
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


def _triangle(r: int) -> int:
    """Entries on and above the diagonal of an r x r matrix: one partial
    holds these."""
    return r * (r + 1) // 2


def gram_cuda(Xs: torch.Tensor) -> torch.Tensor:
    """G = Xs Xs^T by the Hopper kernel; Xs float32, contiguous, on the card."""
    X3 = Xs.unsqueeze(0) if Xs.dim() == 2 else Xs
    _build.require(X3, "Xs", "gram", 3)
    k, d, m = X3.shape
    if min(k, d, m) < 1 or k > 65535:
        raise ValueError(f"gram: need 1 <= k <= 65535 and d, m >= 1, "
                         f"got shape {tuple(Xs.shape)}")
    chunk, nchunks = chunking(m)
    part = torch.empty(k * nchunks * _triangle(d), dtype=torch.float32,
                       device=X3.device)
    G = torch.empty(k, d, d, dtype=torch.float32, device=X3.device)
    if _build.launch("gram", "gram_f32", _ARGS, "gram", X3, X3.data_ptr(),
                     part.data_ptr(), G.data_ptr(), k, d, m, chunk, nchunks,
                     _build.stream_of(X3)):
        gram_cuda.launches += 1
    return G if Xs.dim() == 3 else G[0]


gram_cuda.launches = 0


def gram_gather_cuda(Xy_rows: torch.Tensor, idx: torch.Tensor, r: int,
                     inv_m: float, out=None):
    """G (k, d, d) and R (k, d), d = r - 1, of the draws idx (k, m) over the
    rows of Xy_rows (n, r_pad), both times inv_m, by the Hopper kernel:
    entry (i, j) of the draw b is inv_m * sum_s Xy_rows[idx[b, s], i] *
    Xy_rows[idx[b, s], j], R the column j = d.

    Xy_rows is float32, contiguous, on the card, with 16-byte rows (r_pad a
    multiple of 4) and r <= r_pad; its columns past r take part in nothing.
    idx is int64, contiguous, on the same card, read in place; a row drawn
    twice counts twice. The indices are not range-checked on the card (that
    would cost a host sync): each must lie in [0, n), as the solvers draw
    them. ``out``: see :func:`ref.split_out`."""
    what = "gram_gather"
    for name, t, dtype in (("Xy_rows", Xy_rows, torch.float32),
                           ("idx", idx, torch.int64)):
        if t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{what}: {name} must have 2 dims, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    r_pad = Xy_rows.shape[1]
    if not 2 <= r <= r_pad:
        raise ValueError(f"{what}: need 2 <= r <= r_pad = {r_pad}, got r={r}")
    if r_pad % 4 or Xy_rows.data_ptr() % 16:
        raise ValueError(f"{what}: rows must be 16-byte aligned (r_pad a "
                         f"multiple of 4, got {r_pad})")
    if not _build.on_card(Xy_rows) or idx.device != Xy_rows.device:
        raise ValueError(f"{what}: Xy_rows and idx must be on one CUDA "
                         f"device, got {Xy_rows.device} and {idx.device}")
    k, m = idx.shape
    if min(k, m) < 1 or k > 65535:
        raise ValueError(f"{what}: need 1 <= k <= 65535 and m >= 1, got "
                         f"idx shape {tuple(idx.shape)}")
    chunk, nchunks = chunking(m)
    dev = Xy_rows.device
    part = torch.empty(k * nchunks * _triangle(r), dtype=torch.float32,
                       device=dev)
    G, R = ref.split_out(out, k, r - 1, dev)
    if _build.launch("gram", "gram_gather_f32", _GATHER_ARGS, what, Xy_rows,
                     Xy_rows.data_ptr(), idx.data_ptr(), part.data_ptr(),
                     G.data_ptr(), R.data_ptr(), k, r, r_pad, m, chunk,
                     nchunks, float(inv_m), _build.stream_of(Xy_rows)):
        gram_gather_cuda.launches += 1
    return G, R


gram_gather_cuda.launches = 0


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

@registry.register_work("gram")
def gram_work(Xs: torch.Tensor) -> registry.Work:
    """G = Xs Xs^T of (r, m) or (k, r, m): Xs read once and G written once;
    G is symmetric, so r (r + 1) / 2 distinct entries of 2 m FLOP each."""
    k, r, m = (1, *Xs.shape) if Xs.dim() == 2 else tuple(Xs.shape)
    return registry.Work(flops=1.0 * k * r * (r + 1) * m,
                         bytes=4.0 * (k * r * m + k * r * r),
                         dtype=torch.float32)


@registry.register_work("gram_gather")
def gram_gather_work(Xy_rows: torch.Tensor, idx: torch.Tensor, r: int,
                     inv_m: float = 1.0, out=None, *,
                     distinct: Optional[int] = None) -> registry.Work:
    """Each distinct row drawn read once (its r floats), the draws read
    once, G and R written once; r (r + 1) / 2 entries of m FMAs a draw.
    ``distinct``: how many distinct rows ``idx`` draws; by default counted
    from ``idx`` (a read of the device, so a measurement's, not a
    solve's), and for a fake ``idx`` (the dry run: no values) the most it
    can be, min(k m, n)."""
    k, m = idx.shape
    if distinct is None:
        distinct = (min(k * m, Xy_rows.shape[0]) if _build.is_fake(idx)
                    else int(torch.unique(idx).numel()))
    return registry.Work(
        flops=1.0 * k * m * r * (r + 1),
        bytes=(4.0 * distinct * r + idx.element_size() * k * m
               + 4.0 * k * (r - 1) * r),
        dtype=torch.float32)


registry.register("gram", "cuda", unavailable=_build.unavailable_reason,
                  rejects=_build.rejects_cpu)(gram_cuda)
registry.register("gram", "torch")(ref.gram)
registry.register("gram_gather", "cuda", unavailable=_build.unavailable_reason,
                  rejects=_build.rejects_cpu)(gram_gather_cuda)
registry.register("gram_gather", "torch")(ref.gram_gather)

"""Ops ``flash_attention``, ``flash_dq``, ``flash_dkv`` and
``paged_attention``: the model's attention kernels, in the model's
(B, S, H, D) layout, and :func:`flash_attention`, the differentiable
attention the model calls.

``cuda`` launches ``csrc/flash_attention.cu``: ``flash_attention_fwd``
(counterpart of the Pallas kernel ``repro.kernels.flash_attention.kernel
.flash_attention``, with its lse output on request), ``flash_attention_bwd_dq``
and ``flash_attention_bwd_dkv`` (counterparts of ``backward.flash_dq`` and
``backward.flash_dkv``, the GQA group sum folded into the latter) and
``paged_decode`` (counterpart of ``paged_flash_decode``); ``torch`` is
``ref.py``. For ``paged_attention`` the ``torch`` impl is
``ref.paged_decode_gathered``, the port of the JAX registry's ``xla`` impl
of the op (its engine's route off a TPU: pages gathered, then the slot
decode's chunked attention), and the kernel is held to
``ref.paged_decode``, the Pallas kernel's arithmetic, as in the JAX
package. The JAX wrappers pad the head dim to 128 lanes, the sequence to
the block size and the page rows to 8 before the kernel; here the kernels
mask ragged edges themselves and there is no pad pass over the sequence.
The kernels are built for head dims 16, 32, 64 and 128, the paged kernel
for 80 as well (zamba2's: the engine's pool is read in place); any other
head dim up to 128 that is a multiple of 8 (zamba2's 80 in the flash
kernels) runs zero-padded to the next of them, with the scale of the true
one (:func:`call_padded`). The flash kernels take their operands'
strides, so the model hands them the projections as views, without a copy;
their bases and strides must be 16-byte aligned, since the bf16 kernels
read them by TMA.

Each CUDA wrapper counts its launches in a plain-integer ``launches``
attribute: ``flash_attention_cuda.launches`` (with or without lse),
``flash_dq_cuda.launches``, ``flash_dkv_cuda.launches``,
``paged_decode_cuda.launches``. One ``paged_decode`` call is one CUDA
launch: the chunks of a long row merge inside it (a ticket per row and kv
head), and its pools reach the kernel through TMA tensor maps that are
encoded once per pool and kept (:func:`_paged_maps`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.flash_attention import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FLASH_ARGS = [_P] * 5 + [_I] * 7 + [_P, _I, _F, _P]
_DQ_ARGS = [_P] * 7 + [_I] * 7 + [_P, _I, _F, _P]
_DKV_ARGS = [_P] * 8 + [_I] * 7 + [_P, _I, _F, _P]
_PAGED_ARGS = [_P] * 10 + [_I] * 9 + [_F, _P]
_MAP_ARGS = [_P] * 2 + [_I] * 5
#: positions per CTA of the paged kernel (``PD_CHUNK`` in the source)
PAGED_CHUNK = 128
#: page size the paged kernel takes at most: TMA's limit on a box's rows.
#: The kernel loads a page in boxes of up to 64 rows (``PD_BOX_ROWS``), so
#: float32 pages past that still fit its shared memory.
MAX_PAGE_SIZE = 256
#: head dims the kernels are instantiated for; the others run padded
HEAD_DIMS = (16, 32, 64, 128)
#: head dims the paged kernel is instantiated for: also zamba2's 80, so it
#: reads the engine's pool where it lies (a padded call would copy both
#: pools to D = 128 every call, and miss the kept tensor maps)
PAGED_HEAD_DIMS = (16, 32, 64, 80, 128)
#: query heads per kv head the paged kernel serves at most
MAX_GROUP = 8
_TYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _check(t: torch.Tensor, name: str, what: str, ndim: int,
           dtypes) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: {name} must be on a CUDA device, "
                         f"got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{what}: {name} must be one of "
                         f"{[str(d) for d in dtypes]}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: {name} must have {ndim} dims, "
                         f"got shape {tuple(t.shape)}")


def _gqa(Hq: int, Hkv: int, what: str) -> None:
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{what}: GQA requires Hq % Hkv == 0, got "
                         f"Hq={Hq} Hkv={Hkv}")


def padded_head_dim(D: int, what: str) -> int:
    """The instantiated head dim a call at head dim ``D`` runs at: D itself
    or the next one up. Raises for a D past 128 or not a multiple of 8."""
    if D < 1 or D > HEAD_DIMS[-1] or D % 8:
        raise ValueError(f"{what}: head dim {D} must be a multiple of 8 up "
                         f"to {HEAD_DIMS[-1]}")
    return next(d for d in HEAD_DIMS if d >= D)


def call_padded(fn, heads, rest=(), *, n_out: int = 1,
                scale: Optional[float] = None, **kw):
    """``fn`` at the instantiated head dim, as the JAX wrappers pad D to 128
    lanes (``repro.kernels.flash_attention.ops``): the head-dim tensors
    ``heads`` zero-padded on their last axis, ``rest`` passed as it is,
    ``scale`` taken from the true D, and the first ``n_out`` outputs sliced
    back to D. Zero columns add exact zeros to every score and leave the
    true columns of every output as they were."""
    D = heads[0].shape[-1]
    Dp = padded_head_dim(D, fn.__name__)
    out = fn(*(torch.nn.functional.pad(t, (0, Dp - D)) for t in heads),
             *rest, scale=D ** -0.5 if scale is None else scale, **kw)
    if not isinstance(out, tuple):
        return out[..., :D]
    return tuple(o[..., :D] if i < n_out else o for i, o in enumerate(out))


def _check_qkv(q, k, v, what: str, extra=()):
    """Validate the flash kernels' strided operands: q-shaped ``extra``
    tensors (do) beside q, k and v, a head dim that
    :func:`padded_head_dim` takes, and base and strides 16-byte aligned
    (TMA's rule; the stride of a dim of size 1 is never stepped). Returns
    (B, Sq, Hq, Hkv, Skv, D)."""
    dtypes = (torch.float32, torch.bfloat16)
    operands = (("q", q), ("k", k), ("v", v), *extra)
    for name, t in operands:
        _check(t, name, what, 4, dtypes)
        if t.dtype != q.dtype:
            raise ValueError(f"{what}: q, k, v and do must share a dtype, "
                             f"got {name} {t.dtype} beside q {q.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{what}: {name} needs a unit stride on its "
                             f"last dim, got strides {t.stride()}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} disagree")
    for name, t in extra:
        if t.shape != q.shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} must have "
                             f"q's shape {tuple(q.shape)}")
    _gqa(Hq, Hkv, what)
    padded_head_dim(D, what)
    if min(B, Sq, Skv) < 1 or B > 65535 or Hq > 65535:
        raise ValueError(f"{what}: unsupported shape q {tuple(q.shape)} "
                         f"k {tuple(k.shape)}")
    for name, t in operands:
        esz = t.element_size()
        if t.data_ptr() % 16 or any(
                s * esz % 16 for s, n in zip(t.stride()[:3], t.shape)
                if n > 1):
            raise ValueError(f"{what}: {name} rows must be 16-byte aligned "
                             f"(base and strides)")
    return B, Sq, Hq, Hkv, Skv, D


def _check_rows(t: torch.Tensor, name: str, what: str, shape) -> None:
    """lse and delta: float32 (B, Hq, Sq), contiguous, on the card."""
    _check(t, name, what, 3, (torch.float32,))
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous {tuple(shape)}, "
                         f"got {tuple(t.shape)} strides {t.stride()}")


def _strides(*ts) -> ctypes.Array:
    return (ctypes.c_int64 * (3 * len(ts)))(
        *[s for t in ts for s in t.stride()[:3]])


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """GQA attention by the Hopper kernel. q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D),
    float32 or bf16 (all three alike), unit stride on D, base and strides
    16-byte aligned (the bf16 kernel reads them by TMA) -> (B,Sq,Hq,D) in
    q's dtype; with ``return_lse`` also lse (B,Hq,Sq) float32, the row
    logsumexp of the scaled scores (-inf for a row that sees no key).
    Causal rows are right-aligned (query i sees keys [0, Skv - Sq + i])."""
    what = "flash_attention"
    B, Sq, Hq, Hkv, Skv, D = _check_qkv(q, k, v, what)
    if D not in HEAD_DIMS:
        return call_padded(flash_attention_cuda, (q, k, v), causal=causal,
                           scale=scale, return_lse=return_lse)
    scale = D ** -0.5 if scale is None else float(scale)
    o = torch.empty(B, Sq, Hq, D, dtype=q.dtype, device=q.device)
    lse = (torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = _strides(q, k, v, o)
    fn = _build.function("flash_attention", "flash_attention_fwd",
                         _FLASH_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr() if return_lse else None, _TYPE[q.dtype], B, Hq,
             Hkv, Sq, Skv, D, ctypes.cast(strides, ctypes.c_void_p),
             int(bool(causal)), scale, _build.stream_of(q))
    _build.check("flash_attention", err, what)
    flash_attention_cuda.launches += 1
    return (o, lse) if return_lse else o


flash_attention_cuda.launches = 0


def flash_dq_cuda(q, k, v, do, lse, delta, *, causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """dq of the attention by the Hopper kernel: q/do (B,Sq,Hq,D), k/v
    (B,Skv,Hkv,D) as for the forward (16-byte aligned, do too), lse and
    delta (B,Hq,Sq) float32 contiguous -> dq (B,Sq,Hq,D) in q's dtype."""
    what = "flash_dq"
    B, Sq, Hq, Hkv, Skv, D = _check_qkv(q, k, v, what, (("do", do),))
    _check_rows(lse, "lse", what, (B, Hq, Sq))
    _check_rows(delta, "delta", what, (B, Hq, Sq))
    if D not in HEAD_DIMS:
        return call_padded(flash_dq_cuda, (q, k, v, do), (lse, delta),
                           causal=causal, scale=scale)
    scale = D ** -0.5 if scale is None else float(scale)
    dq = torch.empty(B, Sq, Hq, D, dtype=q.dtype, device=q.device)
    strides = _strides(q, k, v, do, dq)
    fn = _build.function("flash_attention", "flash_attention_bwd_dq",
                         _DQ_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _TYPE[q.dtype],
             B, Hq, Hkv, Sq, Skv, D, ctypes.cast(strides, ctypes.c_void_p),
             int(bool(causal)), scale, _build.stream_of(q))
    _build.check("flash_attention", err, what)
    flash_dq_cuda.launches += 1
    return dq


flash_dq_cuda.launches = 0


def flash_dkv_cuda(q, k, v, do, lse, delta, *, causal: bool = True,
                   scale: Optional[float] = None):
    """(dk, dv) of the attention by the Hopper kernel, summed over each kv
    head's GQA group inside it: operands as for :func:`flash_dq_cuda` ->
    dk, dv (B,Skv,Hkv,D) in k's dtype."""
    what = "flash_dkv"
    B, Sq, Hq, Hkv, Skv, D = _check_qkv(q, k, v, what, (("do", do),))
    _check_rows(lse, "lse", what, (B, Hq, Sq))
    _check_rows(delta, "delta", what, (B, Hq, Sq))
    if D not in HEAD_DIMS:
        return call_padded(flash_dkv_cuda, (q, k, v, do), (lse, delta),
                           n_out=2, causal=causal, scale=scale)
    scale = D ** -0.5 if scale is None else float(scale)
    dk = torch.empty(B, Skv, Hkv, D, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    strides = _strides(q, k, v, do, dk)
    fn = _build.function("flash_attention", "flash_attention_bwd_dkv",
                         _DKV_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             _TYPE[q.dtype], B, Hq, Hkv, Sq, Skv, D,
             ctypes.cast(strides, ctypes.c_void_p), int(bool(causal)), scale,
             _build.stream_of(q))
    _build.check("flash_attention", err, what)
    flash_dkv_cuda.launches += 1
    return dk, dv


flash_dkv_cuda.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Attention with the FA-2 backward, the counterpart of the JAX
    package's ``custom_vjp`` (``flash_attention_fwd``/``_bwd`` in
    ``repro.kernels.flash_attention.ops``): the forward runs the
    ``flash_attention`` op with its lse and saves (q, k, v, o, lse); the
    backward computes delta = rowsum(do * o) in float32 and runs the ops
    ``flash_dq`` and ``flash_dkv``. Every op dispatches under the backend
    resolved when the forward ran (the backward may run on autograd's own
    thread, where a ``registry.use`` of the caller does not reach)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, backend):
        with registry.use(backend):
            o, lse = registry.dispatch("flash_attention", q, k, v,
                                       causal=causal, scale=scale,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.backend = causal, scale, backend
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        with registry.use(ctx.backend):
            dq = registry.dispatch("flash_dq", q, k, v, do, lse, delta, **kw)
            dk, dv = registry.dispatch("flash_dkv", q, k, v, do, lse, delta,
                                       **kw)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None):
    """Differentiable GQA attention, (B, S, H, D) layout. With grad enabled
    and an input that requires it, :class:`FlashAttentionFn` (the lse
    forward, then ``flash_dq`` and ``flash_dkv`` in the backward); otherwise
    the plain ``flash_attention`` op, exactly as inference launches it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(
            q, k, v, causal, scale, registry.resolved_backend(q.device))
    return registry.dispatch("flash_attention", q, k, v, causal=causal,
                             scale=scale)


def paged_splits(npages: int, page_size: int) -> int:
    """CTAs along a row of the paged kernel's grid: chunks of
    :data:`PAGED_CHUNK` positions over the table's reach, at least one (the
    first writes a row with no valid position)."""
    return max(-(-npages * page_size // PAGED_CHUNK), 1)


#: the paged kernel's scratch, one pair per (device, stream): its chunk
#: states (m, l, acc), grown when a call needs more, and its tickets, one
#: int32 per (row, kv head), zeroed once (every launch leaves them zero).
#: The launches on one stream run in order, so they can share both, and a
#: decode step allocates nothing for them.
_SCRATCH: dict = {}


def _paged_scratch(device: torch.device, stream: int, part_numel: int,
                   n_tickets: int):
    key = (device.index, stream)
    pair = _SCRATCH.get(key)
    if (pair is None or pair[0].numel() < part_numel
            or pair[1].numel() < n_tickets):
        part, tickets = pair if pair is not None else (None, None)
        if part is None or part.numel() < part_numel:
            part = torch.empty(part_numel, dtype=torch.float32,
                               device=device)
        if tickets is None or tickets.numel() < n_tickets:
            tickets = torch.zeros(n_tickets, dtype=torch.int32,
                                  device=device)
        pair = _SCRATCH[key] = (part, tickets)
    return pair


#: the pools' TMA tensor maps (128 bytes each), by :func:`_paged_map_key`:
#: (the K map's address, the V map's address, the two buffers). A map
#: holds only the pool's address, shape and type, so a key that comes back
#: names the same map even for a pool allocated anew there. The engine's
#: pools are allocated once and written in place, so its 24 layers need
#: 24 pairs; a cache past :data:`_MAX_MAPS` pairs starts over.
_MAPS: dict = {}
_MAX_MAPS = 256


def _paged_map_key(k_pool: torch.Tensor, v_pool: torch.Tensor) -> tuple:
    """What a pair of tensor maps depends on: both pools' addresses (unique
    across devices: CUDA gives every device's memory its own range of one
    virtual address space), and their (shared) shape and dtype."""
    return k_pool.data_ptr(), v_pool.data_ptr(), k_pool.shape, k_pool.dtype


def _paged_maps(k_pool: torch.Tensor, v_pool: torch.Tensor) -> tuple:
    """The addresses of the K and V pools' tensor maps (and the buffers
    that hold them), encoded at the first call for a key and kept."""
    key = _paged_map_key(k_pool, v_pool)
    maps = _MAPS.get(key)
    if maps is None:
        fn = _build.function("flash_attention", "paged_decode_map",
                             _MAP_ARGS)
        num_pages, P, Hkv, D = k_pool.shape
        bufs = tuple(ctypes.create_string_buffer(128) for _ in range(2))
        for buf, pool in zip(bufs, (k_pool, v_pool)):
            err = fn(ctypes.addressof(buf), pool.data_ptr(),
                     _TYPE[pool.dtype], num_pages, P, Hkv, D)
            _build.check("flash_attention", err, "paged_decode")
        if len(_MAPS) >= _MAX_MAPS:
            _MAPS.clear()
        maps = _MAPS[key] = (ctypes.addressof(bufs[0]),
                             ctypes.addressof(bufs[1]), bufs)
    return maps


def paged_decode_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, page_table: torch.Tensor,
                      kv_valid_len: torch.Tensor, *,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention through a page table by the Hopper kernel.
    q (B,1,Hq,D) float32 or bf16; pools (num_pages, page_size, Hkv, D)
    float32, bf16 or int8 (int8 with ``k_scale``/``v_scale``
    (num_pages, page_size, Hkv) float32); page_table (B, npages) int32;
    kv_valid_len (B,) int32; all contiguous, on the card -> (B,1,Hq,D) in
    q's dtype. Nothing here reads a device value back to the host."""
    what = "paged_decode"
    _check(q, "q", what, 4, (torch.float32, torch.bfloat16))
    _check(k_pool, "k_pool", what, 4,
           (torch.float32, torch.bfloat16, torch.int8))
    _check(v_pool, "v_pool", what, 4, (k_pool.dtype,))
    _check(page_table, "page_table", what, 2, (torch.int32,))
    _check(kv_valid_len, "kv_valid_len", what, 1, (torch.int32,))
    quant = k_pool.dtype == torch.int8
    if (k_scale is None) != (v_scale is None) or (k_scale is None) == quant:
        raise ValueError(f"{what}: k_scale and v_scale come together, with "
                         f"an int8 pool and only then")
    B, S, Hq, D = q.shape
    npg, P, Hkv = k_pool.shape[:3]
    if S != 1:
        raise ValueError(f"{what}: expects a single query, got S={S}")
    if k_pool.shape != (npg, P, Hkv, D) or v_pool.shape != k_pool.shape:
        raise ValueError(f"{what}: pools {tuple(k_pool.shape)} "
                         f"{tuple(v_pool.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if page_table.shape[0] != B or kv_valid_len.shape != (B,):
        raise ValueError(f"{what}: page_table {tuple(page_table.shape)} and "
                         f"kv_valid_len {tuple(kv_valid_len.shape)} need "
                         f"{B} rows")
    _gqa(Hq, Hkv, what)
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"{what}: at most {MAX_GROUP} query heads per kv "
                         f"head, got {Hq // Hkv}")
    padded_head_dim(D, what)
    if B > 65535 or Hkv > 65535 or P < 1:
        raise ValueError(f"{what}: unsupported shape")
    if P > MAX_PAGE_SIZE:
        raise ValueError(f"{what}: page size {P} past {MAX_PAGE_SIZE}")
    operands = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                ("page_table", page_table), ("kv_valid_len", kv_valid_len)]
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(t, name, what, 3, (torch.float32,))
            if t.shape != (npg, P, Hkv):
                raise ValueError(f"{what}: {name} must be "
                                 f"{(npg, P, Hkv)}, got {tuple(t.shape)}")
            operands.append((name, t))
    for name, t in operands:
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned (TMA "
                             f"reads it)")
    if D not in PAGED_HEAD_DIMS:
        return call_padded(paged_decode_cuda, (q, k_pool, v_pool),
                           (page_table, kv_valid_len), k_scale=k_scale,
                           v_scale=v_scale, scale=scale)
    scale = D ** -0.5 if scale is None else float(scale)
    npages = page_table.shape[1]
    nsplit = paged_splits(npages, P)
    if nsplit > 2 ** 31 - 1:
        raise ValueError(f"{what}: page table too long")
    out = torch.empty_like(q)
    stream = _build.stream_of(q)
    kmap, vmap, _ = _paged_maps(k_pool, v_pool)
    part, tickets = _paged_scratch(q.device, stream,
                                   B * Hq * nsplit * (D + 2), B * Hkv)
    fn = _build.function("flash_attention", "paged_decode", _PAGED_ARGS)
    err = fn(kmap, vmap, q.data_ptr(),
             k_scale.data_ptr() if quant else None,
             v_scale.data_ptr() if quant else None,
             page_table.data_ptr(), kv_valid_len.data_ptr(), part.data_ptr(),
             tickets.data_ptr(), out.data_ptr(), _TYPE[q.dtype],
             _TYPE[k_pool.dtype], B, Hq, Hkv, D, P, npages, nsplit, scale,
             stream)
    _build.check("flash_attention", err, what)
    paged_decode_cuda.launches += 1
    return out


paged_decode_cuda.launches = 0

registry.register("flash_attention", "cuda",
                  unavailable=_build.unavailable_reason,
                  rejects=_build.rejects_cpu)(flash_attention_cuda)
registry.register("flash_attention", "torch")(ref.flash_attention)
registry.register("flash_dq", "cuda", unavailable=_build.unavailable_reason,
                  rejects=_build.rejects_cpu)(flash_dq_cuda)
registry.register("flash_dq", "torch")(ref.flash_dq)
registry.register("flash_dkv", "cuda", unavailable=_build.unavailable_reason,
                  rejects=_build.rejects_cpu)(flash_dkv_cuda)
registry.register("flash_dkv", "torch")(ref.flash_dkv)
registry.register("paged_attention", "cuda",
                  unavailable=_build.unavailable_reason,
                  rejects=_build.rejects_cpu)(paged_decode_cuda)
registry.register("paged_attention", "torch")(ref.paged_decode_gathered)

"""Plain PyTorch versions of the Mamba-2 SSD scan: the CPU path and the
oracle each CUDA kernel of ``csrc/ssd.cu`` is held against on the card
(the counterpart of ``repro.kernels.ssd.ref``, plus the backward).

Per head, with state h_t (P x N) and scalar decay exp(dt_t A):

    h_t = exp(dt_t A) h_{t-1} + dt_t (x_t outer B_t)
    y_t = h_t C_t                      (the D skip is the caller's)

Layouts are the model's: x (Bt, S, H, P), dt (Bt, S, H), A (H,), B and C
(Bt, S, N), one group shared by every head. Per-chunk incoming states are
(Bt, H, S/L, P, N) float32; the backward's dxdt is (Bt, S, H, P), da
(Bt, S, H), and dB and dC come per head, (Bt, S, H, N), all float32.

The chunked versions work on chunks of L steps with cs, the inclusive
cumsum of a = dt A inside the chunk. The decay exp(cs_t - cs_s) is taken
only where t >= s (``exp(where(t >= s, cs_t - cs_s, -inf))``): above the
diagonal cs_t - cs_s can pass 88 and exp overflows to inf, which a select
after the exp hides in a forward but turns into 0 * inf = NaN under
autograd. A sequence that is not a multiple of L is padded with zero steps
(a = 0, x dt = 0, B = C = 0), which is exact.
"""
from __future__ import annotations

from typing import Optional

import torch


def ssd_sequential(x, dt, A, B, C, h0: Optional[torch.Tensor] = None):
    """The step-by-step oracle. Returns y (Bt, S, H, P) in x's dtype and
    h_final (Bt, H, P, N) float32."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    h = (torch.zeros(Bt, H, P, N, dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = B.float(), C.float()
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None, :])                  # (Bt,H)
        upd = (dtf[:, t, :, None] * xf[:, t])[..., None] * \
            Bf[:, t, None, None, :]
        h = decay[..., None, None] * h + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, 1).to(x.dtype), h


def _chunks(x, dt, A, B, C, L: int, dtype=torch.float32):
    """Model layout -> padded chunk views in ``dtype``: xdt (Bt, H, nc, L,
    P), cs (Bt, H, nc, L), B and C (Bt, 1, nc, L, N)."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    nc = -(-S // L)
    pad = nc * L - S
    xdt = x.to(dtype) * dt.to(dtype)[..., None]          # dt folded into x
    a = dt.to(dtype) * A.to(dtype)[None, None, :]        # log-decay
    Bf, Cf = B.to(dtype), C.to(dtype)
    if pad:
        xdt = torch.nn.functional.pad(xdt, (0, 0, 0, 0, 0, pad))
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        Bf = torch.nn.functional.pad(Bf, (0, 0, 0, pad))
        Cf = torch.nn.functional.pad(Cf, (0, 0, 0, pad))
    xc = xdt.reshape(Bt, nc, L, H, P).permute(0, 3, 1, 2, 4)
    cs = torch.cumsum(a.reshape(Bt, nc, L, H).permute(0, 3, 1, 2), dim=-1)
    Bc = Bf.reshape(Bt, 1, nc, L, N)
    Cc = Cf.reshape(Bt, 1, nc, L, N)
    return xc, cs, Bc, Cc


def _decay(cs: torch.Tensor) -> torch.Tensor:
    """(..., L, L): exp(cs_t - cs_s) where t >= s, else exactly 0, the exp
    taken of the select only."""
    L = cs.shape[-1]
    tri = torch.ones(L, L, dtype=torch.bool, device=cs.device).tril()
    lmat = cs[..., :, None] - cs[..., None, :]
    return torch.exp(torch.where(tri, lmat, torch.full_like(lmat,
                                                             -torch.inf)))


def _to_model(t: torch.Tensor, S: int) -> torch.Tensor:
    """(Bt, H, nc, L, D) -> (Bt, S, H, D), the padding cut."""
    Bt, H, nc, L, D = t.shape
    return t.permute(0, 2, 3, 1, 4).reshape(Bt, nc * L, H, D)[:, :S]


def ssd_chunked(x, dt, A, B, C, *, chunk: int = 64,
                h0: Optional[torch.Tensor] = None,
                return_states: bool = False):
    """The block form, the arithmetic of ``repro.kernels.ssd.ref
    .ssd_chunked`` and of the Pallas kernel. Within a chunk:

        y_t = exp(cs_t) (C_t . h_in) + sum_{s<=t} exp(cs_t - cs_s)
              (C_t . B_s) xdt_s
        h'  = exp(cs_L) h_in + sum_s exp(cs_L - cs_s) (xdt_s outer B_s)

    The sums run in float64, as in ``ssd_bwd``, and are rounded once:
    held against a float32 kernel at 1e-5, the oracle's own float32
    rounding would take most of the limit. Returns y (Bt, S, H, P) in x's
    dtype, h_final (Bt, H, P, N) float32 and, with ``return_states``, the
    state entering each chunk (Bt, H, nc, P, N) float32."""
    f64 = torch.float64
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    xc, cs, Bc, Cc = _chunks(x, dt, A, B, C, chunk, f64)
    nc = cs.shape[2]
    CB = Cc @ Bc.transpose(-1, -2)                        # (Bt,1,nc,L,L)
    y = (_decay(cs) * CB) @ xc                            # intra-chunk
    w = torch.exp(cs[..., -1:] - cs)                      # (Bt,H,nc,L)
    chunk_state = (xc * w[..., None]).transpose(-1, -2) @ Bc  # (..,P,N)
    h = (torch.zeros(Bt, H, P, N, dtype=f64, device=x.device)
         if h0 is None else h0.to(f64))
    states = []
    for c in range(nc):
        states.append(h)
        h = torch.exp(cs[:, :, c, -1])[..., None, None] * h \
            + chunk_state[:, :, c]
    h_ins = torch.stack(states, 2)                        # (Bt,H,nc,P,N)
    y = y + torch.exp(cs)[..., None] * (Cc @ h_ins.transpose(-1, -2))
    y = _to_model(y, S).to(x.dtype)
    h, h_ins = h.float(), h_ins.float()
    return (y, h, h_ins) if return_states else (y, h)


def ssd_chunked_rounded(x, dt, A, B, C, *, chunk: int = 64):
    """y of :func:`ssd_chunked` with the two float32 operands of its
    products rounded once to bf16: M' = (C B^T o decay) dt_s before its
    product with x, and each chunk's incoming state before C h^T. What a
    bf16 kernel that kept one term of each would give; run by no path, a
    yardstick for the share of y's bf16 outputs that move (the tensor-core
    ``ssd`` carries both as two bf16 terms)."""
    f64 = torch.float64
    Bt, S, H, P = x.shape
    L = chunk

    def once(t):
        return t.float().to(torch.bfloat16).to(f64)

    xc, cs, Bc, Cc = _chunks(x, dt, A, B, C, L, f64)
    nc = cs.shape[2]
    dtc = torch.nn.functional.pad(dt.to(f64), (0, 0, 0, nc * L - S))
    dtc = dtc.reshape(Bt, nc, L, H).permute(0, 3, 1, 2)
    xr = torch.nn.functional.pad(x.to(f64), (0, 0, 0, 0, 0, nc * L - S))
    xr = xr.reshape(Bt, nc, L, H, P).permute(0, 3, 1, 2, 4)
    M = _decay(cs) * (Cc @ Bc.transpose(-1, -2)) * dtc[..., None, :]
    y = once(M) @ xr
    w = torch.exp(cs[..., -1:] - cs)
    chunk_state = (xc * w[..., None]).transpose(-1, -2) @ Bc
    h = torch.zeros(Bt, H, P, B.shape[-1], dtype=f64, device=x.device)
    states = []
    for c in range(nc):
        states.append(h)
        h = torch.exp(cs[:, :, c, -1])[..., None, None] * h \
            + chunk_state[:, :, c]
    h_ins = once(torch.stack(states, 2))
    y = y + torch.exp(cs)[..., None] * (Cc @ h_ins.transpose(-1, -2))
    return _to_model(y, S).to(x.dtype)


def ssd_bwd(x, dt, A, B, C, dy, states, dh_final=None, *, chunk: int = 64):
    """The reverse chunk scan of ``repro.kernels.ssd.backward``, chunk by
    chunk, carrying dh (P x N). Per chunk, with e = exp(cs), w =
    exp(cs_L - cs), decay as above, CB = C B^T and DYX = dy xdt^T:

        dxdt = (decay CB)^T dy + w (B dh^T)
        dC   = (decay DYX) B + e (dy h_in)
        dB   = (decay DYX)^T C + (w xdt) dh
        dh'  = exp(cs_L) dh + (e dy)^T C
        da   = revcumsum(rowsum(E) - colsum(E) + <dy, y_inter> - w dw)
               + [every row] (sum w dw + exp(cs_L) <h_in, dh>)
               with E = decay CB DYX

    ``states`` are the forward's incoming states (Bt, H, nc, P, N) and
    ``dh_final`` the cotangent of the final state (None: zeros). The sums
    run in float64, as the plain ``gram`` does: da's reverse cumsum
    subtracts large terms, and the oracle's own rounding should not set
    the kernel's tolerance. Returns dxdt (Bt, S, H, P), da (Bt, S, H), dB
    and dC (Bt, S, H, N), all float32."""
    f64 = torch.float64
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    L = chunk
    xc, cs, Bc, Cc = _chunks(x, dt, A, B, C, L, f64)
    nc = cs.shape[2]
    dyc = torch.nn.functional.pad(dy.to(f64), (0, 0, 0, 0, 0, nc * L - S))
    dyc = dyc.reshape(Bt, nc, L, H, P).permute(0, 3, 1, 2, 4)
    dh = (torch.zeros(Bt, H, P, N, dtype=f64, device=x.device)
          if dh_final is None else dh_final.to(f64))
    outs = []
    for c in reversed(range(nc)):
        X, dyv, hin = xc[:, :, c], dyc[:, :, c], states[:, :, c].to(f64)
        Bm, Cm, csc = Bc[:, :, c], Cc[:, :, c], cs[:, :, c]   # (..,L,·)
        csL = csc[..., -1]
        e, w = torch.exp(csc), torch.exp(csL[..., None] - csc)
        decay = _decay(csc)
        CB = Cm @ Bm.transpose(-1, -2)
        DD = decay * (dyv @ X.transpose(-1, -2))
        V = Bm @ dh.transpose(-1, -2)                     # (Bt,H,L,P)
        dxdt = (decay * CB).transpose(-1, -2) @ dyv + w[..., None] * V
        dC = DD @ Bm + e[..., None] * (dyv @ hin)
        dB = DD.transpose(-1, -2) @ Cm + (w[..., None] * X) @ dh
        E = DD * CB
        y_inter = e[..., None] * (Cm @ hin.transpose(-1, -2))
        dw = (X * V).sum(-1) * w
        dcs = E.sum(-1) - E.sum(-2) + (dyv * y_inter).sum(-1) - dw
        dcs[..., -1] += dw.sum(-1) + torch.exp(csL) * (hin * dh).sum((-1, -2))
        da = torch.flip(torch.cumsum(torch.flip(dcs, [-1]), -1), [-1])
        dh = torch.exp(csL)[..., None, None] * dh + \
            (e[..., None] * dyv).transpose(-1, -2) @ Cm
        outs.append((dxdt, da, dB, dC))
    outs.reverse()
    f32 = torch.float32
    dxdt, da, dB, dC = (torch.stack(t, 2) for t in zip(*outs))
    return (_to_model(dxdt, S).to(f32), _to_model(da[..., None], S)[..., 0]
            .to(f32), _to_model(dB, S).to(f32), _to_model(dC, S).to(f32))

"""The Mamba-2 block (SSD, arXiv:2405.21060), the counterpart of
``repro.models.ssm``: a fused input projection gives [z | x | B | C | dt];
(x | B | C) pass through a short causal depthwise convolution; the SSD scan
runs per head with scalar decay exp(dt A); the output is gated by silu(z),
RMS-normed and projected back. Decode keeps an O(1) state per layer: the
convolution's window and the SSM state.

The rounding points are the JAX package's: the projections, the
convolution's taps (one rounded product and one rounded add per tap, in tap
order), the silu gates and the D skip run in the bf16 stream; dt's
softplus, A, and the scan run in float32 (``dt_bias`` and ``A_log`` are
read in float32, so the port keeps them in float32 whatever the dtype of
the other weights).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ssd.ops import ssd, ssd_decode_step
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.models.mlp import silu

#: the leaves the model reads in float32, kept in float32 in a bf16 tree
FLOAT32_LEAVES = ("A_log", "dt_bias")


def mamba2_dims(d_model: int, cfg):
    """(d_inner, heads H, state N, conv channels, in_proj width)."""
    d_inner = cfg.ssm_expand * d_model
    H = d_inner // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_ch = d_inner + 2 * N
    proj = 2 * d_inner + 2 * N + H          # z, x, B, C, dt
    return d_inner, H, N, conv_ch, proj


def init_mamba2(gen: torch.Generator, d_model: int, cfg, dtype=torch.float32,
                device=None) -> dict:
    """Random weights from ``gen``, drawn as ``repro.models.ssm
    .init_mamba2`` draws them (other numbers than ``jax.random``): the
    projections and the convolution N(0, 1/fan_in), A_log = log(1..16),
    D = 1, dt_bias the inverse softplus of dt ~ logU(1e-3, 0.1)."""
    d_inner, H, N, conv_ch, proj = mamba2_dims(d_model, cfg)
    f32 = dict(dtype=torch.float32, device=device)
    in_proj = dense_init(gen, (d_model, proj), dtype=dtype, device=device)
    conv_w = dense_init(gen, (cfg.ssm_conv, conv_ch), dtype=dtype,
                        device=device)
    u = torch.rand(H, generator=gen, **f32)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return dict(
        in_proj=in_proj,
        conv_w=conv_w,
        conv_b=torch.zeros(conv_ch, dtype=dtype, device=device),
        A_log=torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        D=torch.ones(H, dtype=dtype, device=device),
        dt_bias=torch.log(torch.expm1(dt0)),
        norm=torch.ones(d_inner, dtype=dtype, device=device),
        out_proj=dense_init(gen, (d_inner, d_model), dtype=dtype,
                            device=device),
    )


def _causal_conv(xBC: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, conv_state=None):
    """Depthwise causal convolution over the sequence: xBC (B, S, ch),
    conv_w (K, ch), both in the stream dtype; ``conv_state`` (B, K-1, ch)
    prepends history (decode). The K taps are summed as JAX sums them, one
    rounded product and one rounded add each, in tap order (``F.conv1d``
    sums in float32 and rounds once). Returns (silu(conv + b), the last
    K-1 rows of the padded input, the next window)."""
    K = conv_w.shape[0]
    bsz, S, ch = xBC.shape
    if conv_state is None:
        pad = torch.zeros(bsz, K - 1, ch, dtype=xBC.dtype, device=xBC.device)
    else:
        pad = conv_state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)                 # (B, S+K-1, ch)
    out = torch.zeros_like(xBC)
    for i in range(K):
        out = out + xp[:, i:i + S] * conv_w[i]
    return silu(out + conv_b), xp[:, S:]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)), written out (``F.softplus`` is log1p(exp(x)) below
    its threshold, another rounding)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _project(params, x, cfg, conv_state=None):
    """The shared front of forward and decode: (z, xs, B, C, dt, A, the
    conv window) with dt softplus-ed and A = -exp(A_log) in float32."""
    d_model = x.shape[-1]
    d_inner, H, N, conv_ch, _ = mamba2_dims(d_model, cfg)
    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z, xBC, dt = torch.split(zxbcdt, [d_inner, conv_ch, H], dim=-1)
    xBC, window = _causal_conv(xBC, params["conv_w"].to(x.dtype),
                               params["conv_b"].to(x.dtype), conv_state)
    xs, Bm, Cm = torch.split(xBC, [d_inner, N, N], dim=-1)
    dt = _softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    return z, xs, Bm, Cm, dt, A, window


def _output(params, y, z, x_dtype):
    """Gate, norm and the output projection of y (B, S, d_inner)."""
    y = y * silu(z)
    y = rms_norm(y, params["norm"].float())
    return y @ params["out_proj"].to(x_dtype)


def mamba2_forward(params: dict, x: torch.Tensor, cfg,
                   ssd_chunk: int = 64) -> torch.Tensor:
    """x (B, S, d_model) -> (B, S, d_model): the training and prefill path.
    The scan runs ``ssd`` (its autograd Function when grad is on), through
    the registry policy."""
    bsz, S, d_model = x.shape
    d_inner, H, N, _, _ = mamba2_dims(d_model, cfg)
    z, xs, Bm, Cm, dt, A, _ = _project(params, x, cfg)
    xh = xs.reshape(bsz, S, H, cfg.ssm_head_dim)   # a view, no copy
    y, _ = ssd(xh, dt, A, Bm, Cm, chunk=ssd_chunk)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    return _output(params, y.reshape(bsz, S, d_inner), z, x.dtype)


def init_mamba2_state(batch: int, d_model: int, cfg, device=None) -> dict:
    """Decode state: ``conv`` (batch, K-1, conv channels) and ``ssm``
    (batch, H, P, N), float32 zeros, as the JAX package makes them."""
    d_inner, H, N, conv_ch, _ = mamba2_dims(d_model, cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return dict(conv=torch.zeros(batch, cfg.ssm_conv - 1, conv_ch, **f32),
                ssm=torch.zeros(batch, H, d_inner // H, N, **f32))


def mamba2_decode_step(params: dict, x_t: torch.Tensor, state: dict, cfg):
    """One token: x_t (B, 1, d_model), ``state`` from
    :func:`init_mamba2_state` -> (out (B, 1, d_model), the new state). The
    scan is the plain recurrence ``ssd_decode_step``."""
    bsz, _, d_model = x_t.shape
    d_inner, H, N, _, _ = mamba2_dims(d_model, cfg)
    z, xs, Bm, Cm, dt, A, window = _project(params, x_t, cfg, state["conv"])
    xh = xs[:, 0].reshape(bsz, H, cfg.ssm_head_dim)
    y_t, h = ssd_decode_step(xh, dt[:, 0], A, Bm[:, 0].float(),
                             Cm[:, 0].float(), state["ssm"])
    y = y_t + params["D"].to(y_t.dtype)[None, :, None] * xh
    out = _output(params, y.reshape(bsz, 1, d_inner), z, x_t.dtype)
    return out, dict(conv=window, ssm=h)

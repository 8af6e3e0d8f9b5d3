"""Stochastic token selection inside the k-step decode block (the
counterpart of ``repro.serve.sampling``).

Every draw happens on the device, inside the block: per-slot PRNG keys ride
with the slot (seeded at admission, permuted by defrag: see
``CachePool.seed_slot``), and the t-th generated token of a request draws
with ``fold_in(request_key, t)``. The draw index is the emission count, not
the step, so token streams are bit-identical across k, engine restarts and
slot placement.

The draws are JAX's own: the keys are threefry2x32 key words as
``jax.random.PRNGKey`` lays them out, ``fold_in`` and the Gumbel noise are
threefry2x32 computed on the device in int64 arithmetic masked to 32 bits,
with the counter layout of ``jax.random.bits`` under jax 0.9.0's default
``jax_threefry_partitionable=True`` (counter i of a (V,) draw is the pair
(0, i), the bits are the two output words XOR-ed) and JAX's float-from-bits
conversion (``uniform(minval=tiny, maxval=1)``). The noise bits, the
uniforms and the keys equal JAX's bit for bit; the Gumbel transform
``-log(-log(u))`` runs on torch's ``log``, which may differ from XLA's by
an ulp (held to 1 ulp by ``tests/test_torch_sampling.py``).

Greedy stays greedy: rows with ``temperature <= 0`` return the argmax the
serve step computed, bit for bit, and a batch that is all greedy skips the
sampler: the engine decides that from its host copy of the policy and
passes no ``SlotSampling`` (no host read of a device value).

Top-k truncates first, then the nucleus over the renormalised survivors:
scale by temperature, sort descending (stable, as ``jnp.argsort(-x)``),
drop ranks >= top_k, then ranks outside the minimal prefix whose softmax
mass reaches top_p, then Gumbel-max over the surviving logits in rank
order, which is a draw from the renormalised truncated distribution. No
Pallas kernel lies here: plain torch ops.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy.

    temperature: 0 (the default) is the greedy fast path — bit-identical to
    the argmax engine. > 0 samples from softmax(logits / temperature).
    top_p: nucleus mass; keep the minimal set of highest-probability tokens
    whose mass is >= top_p, renormalize, sample. 1.0 disables.
    top_k: keep only the k highest logits (0 disables).
    seed: stream seed. Two requests with the same seed and prompt produce
    the same tokens regardless of k, slot, or engine instance. None lets
    the engine draw a fresh seed at admission.
    """
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    seed: Optional[int] = None

    def __post_init__(self):
        # non-finite values must be rejected explicitly: every ordered
        # comparison against NaN is False, so ``temperature=float("nan")``
        # sails through the range checks below, reads as non-greedy, and
        # turns the scaled logits all-NaN at draw time
        if not math.isfinite(self.temperature) or self.temperature < 0.0:
            raise ValueError(
                f"temperature must be finite and >= 0, got {self.temperature}")
        if not math.isfinite(self.top_p) or not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be finite and in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


class SlotSampling(NamedTuple):
    """Device-side per-slot sampling state fed to the block each round.

    All (B,)-shaped except ``key`` (B, 2): the raw per-slot threefry key
    words (``jax.random.PRNGKey`` rows) as int64 values in [0, 2**32).
    Slots running greedy carry temperature 0 and a zero key.
    """
    temperature: torch.Tensor   # (B,) float32; <= 0 means greedy
    top_p: torch.Tensor         # (B,) float32
    top_k: torch.Tensor         # (B,) int32; 0 disables
    key: torch.Tensor           # (B, 2) int64 key words


# a temperature-0 row still flows through the masked math under where();
# the clamp only keeps its (discarded) lane finite
_TEMP_FLOOR = 1e-6
_M32 = 0xFFFFFFFF
# Rotation schedule + key-parity constant of threefry2x32 — the PRNG behind
# jax.random.PRNGKey / fold_in.
_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA
#: float32's smallest normal: jax.random.gumbel's uniform minval
_TINY = float(np.finfo(np.float32).tiny)
#: maxval - minval of that uniform in float32 (it rounds to 1.0)
_SPAN = float(np.float32(1.0) - np.float32(_TINY))


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block on tensors of 32-bit words held in int64
    (every sum masked back to 32 bits): key (k0, k1), counter (x0, x1),
    broadcast together -> the two output words. The 20 rounds of
    ``jax.random``'s threefry2x32 (and of :func:`host_fold_in`)."""
    ks = (k0, k1, k0 ^ k1 ^ _THREEFRY_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for d in range(5):
        for r in _THREEFRY_ROT[d % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(d + 1) % 3]) & _M32
        x1 = (x1 + ks[(d + 2) % 3] + (d + 1)) & _M32
    return x0, x1


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` row by row on the device: key (B, 2) int64 key
    words, data (B,) -> (B, 2) int64 key words. fold_in(key, d) is
    threefry2x32(key, [0, d])."""
    d = data.to(torch.int64) & _M32
    y0, y1 = threefry2x32(key[:, 0], key[:, 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each row of key (B, 2)
    under ``jax_threefry_partitionable=True``: counter i is the pair
    (0, i), and the 32 bits are the two output words XOR-ed. Returns (B, n)
    int64 in [0, 2**32)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)[None, :]
    b0, b1 = threefry2x32(key[:, :1], key[:, 1:], torch.zeros_like(i), i)
    return b0 ^ b1


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(minval=tiny, maxval=1, dtype=float32)`` from
    its 32 random bits: the top 23 bits as the mantissa of a float in
    [1, 2), minus 1, times (maxval - minval) (1.0 in float32), plus minval,
    at least minval."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * _SPAN + _TINY, _TINY)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low") for each row
    of key (B, 2): -log(-log(u)) of :func:`uniform_from_bits`. (B, n)."""
    u = uniform_from_bits(random_bits(key, n))
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, greedy_tok: torch.Tensor,
                  samp: SlotSampling, n_out: torch.Tensor) -> torch.Tensor:
    """Draw one token per row, entirely on the device (no host read).

    logits: (B, V) final-position logits. greedy_tok: (B,) the argmax the
    serve step computed, returned verbatim for greedy rows. n_out: (B,)
    tokens already emitted per slot; the draw for the t-th generated token
    folds t into the slot's request key. The caller skips this function
    for an all-greedy batch (``repro.serve.sampling`` does so with a
    ``lax.cond``; the tokens are the same).
    """
    B, V = logits.shape
    greedy = samp.temperature <= 0.0
    x = logits.float() / torch.clamp_min(samp.temperature,
                                         _TEMP_FLOOR)[:, None]
    xs, order = torch.sort(x, dim=-1, descending=True, stable=True)
    # top-k truncates first; the nucleus is then computed over the
    # renormalised top-k survivors
    kk = torch.where(samp.top_k > 0, samp.top_k,
                     torch.full_like(samp.top_k, V))
    rank = torch.arange(V, device=logits.device)[None, :]
    rank_keep = rank < kk[:, None]
    neg_inf = torch.full((), float("-inf"), device=logits.device)
    probs = torch.softmax(torch.where(rank_keep, xs, neg_inf), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # nucleus: rank i survives iff the mass strictly before it is still
    # short of top_p (rank 0 always survives, since 0 < top_p)
    keep = rank_keep & ((cum - probs) < samp.top_p[:, None])
    masked = torch.where(keep, xs, neg_inf)
    # Gumbel-max over the masked logits in rank order: one fresh key per
    # (slot, emission index)
    g = gumbel(fold_in(samp.key, n_out), V)
    pick = torch.argmax(masked + g, dim=-1)
    sampled = order.gather(1, pick[:, None])[:, 0].to(torch.int32)
    return torch.where(greedy, greedy_tok.to(torch.int32), sampled)


# ---------------------------------------------------------------------------
# Host-side threefry fold_in (fan-out stream keys)
# ---------------------------------------------------------------------------
def host_fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in`` on raw host key data, bit-identical.

    key: (2,) uint32 threefry2x32 key words (the ``CachePool`` slot-key
    layout); data: the fold index. Returns the derived (2,) uint32 key.

    n>1 fan-out derives stream i's request key as ``fold_in(base_key, i)``
    at admission. Doing that on the device would need the key fetched back
    — an uncounted host sync per admitted stream, exactly the class of
    hidden sync ``obs.sync_audit`` polices. So :func:`threefry2x32` runs
    here on Python ints; ``tests/test_torch_sampling.py`` pins
    bit-equality against ``jax.random.fold_in``.
    """
    # fold_in(key, d) == threefry2x32(key, threefry_seed(uint32(d))), and
    # threefry_seed of a 32-bit input is the block [0, d]
    return np.array(threefry2x32(int(key[0]), int(key[1]), 0,
                                 int(data) & _M32), np.uint32)


def fold_in_seed(seed: int, index: int) -> int:
    """The integer seed whose ``PRNGKey`` equals ``fold_in(PRNGKey(seed),
    index)`` — i.e. the standalone-request seed that reproduces fan-out
    stream ``index`` bit for bit (``PRNGKey`` packs a 64-bit seed as
    ``[seed >> 32, seed & 0xffffffff]``)."""
    hi, lo = host_fold_in(
        np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32), index)
    return (int(hi) << 32) | int(lo)

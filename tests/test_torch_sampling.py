"""The port's sampler (``repro_torch.serve.sampling``) against the JAX
package's, and the engine's sampled determinism.

- The draws are JAX's: the device ``fold_in`` and ``random_bits`` equal
  ``jax.random.fold_in`` / ``jax.random.bits`` bit for bit (jax 0.9.0,
  ``jax_threefry_partitionable`` on), and so does ``host_fold_in``; the
  uniforms behind ``jax.random.gumbel`` are equal bit for bit, and each of
  the two logs of ``-log(-log(u))`` is within 1 ulp of XLA's (torch's log
  and XLA's round differently in about one case in seven).
- ``sample_tokens`` picks JAX's tokens on seeded logits, mixed policies
  and emission counts.
- The distribution harness of ``tests/test_sampling.py``: chi-squared
  against the renormalised truncated softmax, the nucleus support, top-k,
  top-k before top-p, T -> 0 and greedy rows in a sampled batch.
- The engine: a seeded stream is identical across k, restarts, slots and
  defrag; sampling adds no host sync; streamed deltas reassemble the
  responses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import sampling as jsampling
from repro_torch.configs import get_arch, smoke_config
from repro_torch.models import init_params
from repro_torch.serve import (Engine, FINISH_ERROR, Request, SamplingParams,
                               SlotSampling, fold_in_seed, host_fold_in,
                               sample_tokens)
from repro_torch.serve import sampling as tsampling

LOGITS = [2.0, 1.0, 0.0, -1.0, 0.5]
CHI2_999 = {1: 10.83, 2: 13.82, 3: 16.27, 4: 18.47}
TINY = float(np.finfo(np.float32).tiny)


def _keys(n, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 2 ** 32, size=(n, 2), dtype=np.uint64).astype(
        np.uint32)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


# ------------------------------------------------------------ the draws --
def test_fold_in_matches_jax_bit_for_bit():
    keys = _keys(32)
    data = np.random.RandomState(1).randint(0, 2 ** 31, size=32)
    want = np.stack([np.asarray(jax.random.fold_in(jnp.asarray(k), int(d)))
                     for k, d in zip(keys, data)])
    got = tsampling.fold_in(torch.from_numpy(keys.astype(np.int64)),
                            torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    for k, d, w in zip(keys, data, want):
        np.testing.assert_array_equal(host_fold_in(k, int(d)), w)


def test_fold_in_seed_reproduces_key_words():
    for seed, i in ((0, 0), (123, 3), (2 ** 40 + 17, 7)):
        key = jnp.asarray([seed >> 32, seed & 0xFFFFFFFF], jnp.uint32)
        want = np.asarray(jax.random.fold_in(key, i))
        derived = fold_in_seed(seed, i)
        got = np.array([derived >> 32, derived & 0xFFFFFFFF], np.uint32)
        np.testing.assert_array_equal(got, want)
        assert fold_in_seed(seed, i) == jsampling.fold_in_seed(seed, i)


@pytest.mark.parametrize("n", [1, 5, 256, 1001])
def test_random_bits_match_jax_bit_for_bit(n):
    keys = _keys(4, seed=n)
    want = np.stack([np.asarray(jax.random.bits(jnp.asarray(k), (n,),
                                                 jnp.uint32)) for k in keys])
    got = tsampling.random_bits(torch.from_numpy(keys.astype(np.int64)), n)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_gumbel_uniforms_bitwise_and_logs_within_one_ulp():
    """The uniforms behind ``jax.random.gumbel`` equal JAX's bit for bit;
    each log is within 1 ulp of XLA's on the same input, so the noise
    agrees to 1e-6."""
    keys = _keys(6, seed=7)
    n = 5000
    u = tsampling.uniform_from_bits(tsampling.random_bits(
        torch.from_numpy(keys.astype(np.int64)), n)).numpy()
    want_u = np.stack([np.asarray(jax.random.uniform(
        jnp.asarray(k), (n,), jnp.float32, minval=TINY, maxval=1.0))
        for k in keys])
    np.testing.assert_array_equal(u, want_u)
    inner = -np.asarray(jnp.log(jnp.asarray(u)))
    assert _ulps(-torch.log(torch.from_numpy(u)).numpy(), inner).max() <= 1
    assert _ulps(torch.log(torch.from_numpy(inner)).numpy(),
                 np.asarray(jnp.log(jnp.asarray(inner)))).max() <= 1
    g = tsampling.gumbel(torch.from_numpy(keys.astype(np.int64)), n).numpy()
    want_g = np.stack([np.asarray(jax.random.gumbel(jnp.asarray(k), (n,),
                                                    jnp.float32))
                       for k in keys])
    assert np.abs(g - want_g).max() <= 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_tokens_picks_jax_tokens(seed):
    """Seeded logits (bf16, as the model gives them), a batch of mixed
    policies (greedy rows, top-k, top-p, both) and emission counts: the
    port's tokens are JAX's."""
    rng = np.random.RandomState(seed)
    B, V = 16, 256
    logits = (rng.randn(B, V) * 2).astype(np.float32)
    lt = torch.from_numpy(logits).to(torch.bfloat16)
    lj = jnp.asarray(logits).astype(jnp.bfloat16)
    temp = np.where(np.arange(B) % 4 == 0, 0.0,
                    rng.uniform(0.3, 1.5, B)).astype(np.float32)
    top_p = np.where(np.arange(B) % 3 == 0, 1.0,
                     rng.uniform(0.5, 0.95, B)).astype(np.float32)
    top_k = np.where(np.arange(B) % 2 == 0, 0,
                     rng.randint(1, 40, B)).astype(np.int32)
    keys = _keys(B, seed=seed + 10)
    n_out = rng.randint(0, 1000, B).astype(np.int32)
    greedy = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    want = np.asarray(jsampling.sample_tokens(
        lj, jnp.asarray(greedy),
        jsampling.SlotSampling(jnp.asarray(temp), jnp.asarray(top_p),
                               jnp.asarray(top_k), jnp.asarray(keys)),
        jnp.asarray(n_out)))
    got = sample_tokens(
        lt, torch.from_numpy(greedy),
        SlotSampling(torch.from_numpy(temp), torch.from_numpy(top_p),
                     torch.from_numpy(top_k),
                     torch.from_numpy(keys.astype(np.int64))),
        torch.from_numpy(n_out))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[temp <= 0] == greedy[temp <= 0]).all()


# ----------------------------------------------------------- distribution --
def _draws(sp: SamplingParams, n: int, seed: int = 0, logits=LOGITS):
    """n draws through the sampler, one row a draw, row i keyed
    fold_in(PRNGKey(seed), i), draw index 0 (tests/test_sampling.py)."""
    V = len(logits)
    base = np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    keys = np.stack([host_fold_in(base, i) for i in range(n)])
    samp = SlotSampling(
        temperature=torch.full((n,), sp.temperature),
        top_p=torch.full((n,), sp.top_p),
        top_k=torch.full((n,), sp.top_k, dtype=torch.int32),
        key=torch.from_numpy(keys.astype(np.int64)))
    L = torch.tensor(logits).expand(n, V).contiguous()
    greedy = L.argmax(-1).to(torch.int32)
    return sample_tokens(L, greedy, samp,
                         torch.zeros(n, dtype=torch.int32)).numpy()


def _probs(T=1.0):
    x = np.asarray(LOGITS, np.float64) / T
    p = np.exp(x - x.max())
    return p / p.sum()


def _chi2(toks, probs, support):
    counts = np.array([(toks == i).sum() for i in support], float)
    exp = np.asarray(probs)[support] * len(toks)
    return float(((counts - exp) ** 2 / exp).sum())


def test_temperature_sampling_matches_softmax():
    T, n = 0.7, 8000
    toks = _draws(SamplingParams(temperature=T, seed=1), n, seed=1)
    stat = _chi2(toks, _probs(T), list(range(5)))
    assert stat < CHI2_999[4], stat


def test_top_p_support_mass_and_renormalization():
    top_p, n = 0.7, 6000
    probs = _probs()
    order = np.argsort(-probs)
    cum = np.cumsum(probs[order])
    nucleus = sorted(order[:int(np.searchsorted(cum, top_p) + 1)])
    assert probs[nucleus].sum() >= top_p
    toks = _draws(SamplingParams(temperature=1.0, top_p=top_p), n, seed=2)
    assert set(np.unique(toks)) <= set(nucleus)
    stat = _chi2(toks, probs / probs[nucleus].sum(), nucleus)
    assert stat < CHI2_999[len(nucleus) - 1], stat


def test_top_k_support_size():
    top_k, n = 3, 6000
    keep = sorted(np.argsort(-np.asarray(LOGITS))[:top_k])
    toks = _draws(SamplingParams(temperature=1.0, top_k=top_k), n, seed=3)
    assert set(np.unique(toks)) == set(keep)
    probs = _probs()
    stat = _chi2(toks, probs / probs[keep].sum(), keep)
    assert stat < CHI2_999[top_k - 1], stat


def test_temperature_to_zero_degenerates_to_argmax():
    n = 2000
    np.testing.assert_array_equal(_draws(SamplingParams(), n),
                                  np.zeros(n, np.int32))
    np.testing.assert_array_equal(
        _draws(SamplingParams(temperature=0.05), n, seed=4),
        np.zeros(n, np.int32))


def test_mixed_batch_greedy_rows_bitwise_argmax():
    n = 64
    base = np.array([0, 9], np.uint32)
    keys = np.stack([host_fold_in(base, i) for i in range(n)])
    greedy_mask = np.arange(n) % 2 == 0
    samp = SlotSampling(
        temperature=torch.from_numpy(np.where(greedy_mask, 0.0, 5.0)
                                     .astype(np.float32)),
        top_p=torch.ones(n), top_k=torch.zeros(n, dtype=torch.int32),
        key=torch.from_numpy(keys.astype(np.int64)))
    L = torch.tensor(LOGITS).expand(n, 5).contiguous()
    toks = sample_tokens(L, L.argmax(-1).to(torch.int32), samp,
                         torch.zeros(n, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(toks[greedy_mask], 0)
    assert len(set(toks[~greedy_mask])) > 1


def test_top_k_top_p_composition_truncates_in_order():
    top_k, top_p, n = 3, 0.8, 6000
    probs = _probs()
    order = np.argsort(-probs)
    trunc = probs[order[:top_k]] / probs[order[:top_k]].sum()
    before = np.cumsum(trunc) - trunc
    keep = sorted(order[:top_k][before < top_p])
    assert keep == [0, 1]
    toks = _draws(SamplingParams(temperature=1.0, top_k=top_k, top_p=top_p),
                  n, seed=6)
    assert set(np.unique(toks)) == set(keep)
    renorm = np.zeros_like(probs)
    renorm[keep] = trunc[before < top_p] / trunc[before < top_p].sum()
    assert _chi2(toks, renorm, keep) < CHI2_999[len(keep) - 1]


def test_sampling_params_validation():
    for bad in (dict(temperature=-0.1), dict(top_p=0.0), dict(top_p=1.5),
                dict(top_k=-1), dict(temperature=float("nan")),
                dict(temperature=float("inf")), dict(top_p=float("nan"))):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    assert SamplingParams().greedy
    assert not SamplingParams(temperature=0.5).greedy


# ------------------------------------------------------ engine determinism --
CFG = smoke_config(get_arch("internlm2-1.8b"))
SP = SamplingParams(temperature=0.9, top_p=0.95, seed=42)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16, device="cpu")


def _target_stream(params, k, *, num_slots=3, fillers=()):
    eng = Engine(params, CFG, num_slots=num_slots, max_len=32, k=k,
                 max_prompt=8, device="cpu")
    reqs = [Request(id=f"f{i}", prompt=[9 + i], max_new_tokens=mn,
                    sampling=SamplingParams(temperature=1.2, seed=100 + i))
            for i, mn in enumerate(fillers)]
    reqs.append(Request(id="t", prompt=[7, 3], max_new_tokens=8, sampling=SP))
    return {r.id: r.tokens for r in eng.run(reqs)}["t"], eng


def test_seeded_stream_identical_across_k_and_restarts(params):
    streams = {k: _target_stream(params, k)[0] for k in (1, 4, 16)}
    assert streams[1] == streams[4] == streams[16]
    assert len(streams[1]) == 8
    assert _target_stream(params, 4)[0] == streams[4]


def test_seeded_stream_independent_of_slot_and_defrag(params):
    base, _ = _target_stream(params, 4)
    packed, eng = _target_stream(params, 4, num_slots=2, fillers=(6, 2))
    assert packed == base
    assert eng.stats.defrags >= 1


def test_sampling_adds_no_host_syncs(params):
    def drain(sampling):
        eng = Engine(params, CFG, num_slots=4, max_len=32, k=4,
                     max_prompt=4, device="cpu")
        eng.run([Request(id=f"r{i}", prompt=[1 + i], max_new_tokens=8,
                         sampling=sampling) for i in range(4)])
        # retirement resets the slot policy: a drained engine is greedy
        assert (eng._temp <= 0.0).all()
        return eng.stats
    greedy = drain(None)
    sampled = drain(SamplingParams(temperature=0.8, top_p=0.9, seed=5))
    assert sampled.syncs == greedy.syncs
    assert sampled.steps == sampled.syncs * 4
    assert sampled.tokens_out == greedy.tokens_out == 4 * 8


def test_stream_deltas_reassemble_response(params):
    eng = Engine(params, CFG, num_slots=2, max_len=32, k=4, max_prompt=8,
                 device="cpu")
    reqs = [Request(id="a", prompt=[7, 3], max_new_tokens=6, sampling=SP),
            Request(id="b", prompt=[5], max_new_tokens=9)]
    got, final = {}, {}
    for d in eng.stream(reqs):
        assert len(d.tokens) <= 4
        got.setdefault(d.id, []).extend(d.tokens)
        if d.done:
            assert d.response is not None and d.response.id == d.id
            final[d.id] = d.response
    assert set(final) == {"a", "b"}
    for rid, resp in final.items():
        assert got[rid] == resp.tokens
    assert len(got["a"]) == 6 and len(got["b"]) == 9


def test_stream_terminal_delta_for_rejected_request(params):
    eng = Engine(params, CFG, num_slots=2, max_len=16, k=2, max_prompt=4,
                 device="cpu")
    deltas = list(eng.stream([Request(id="long", prompt=[1] * 5,
                                      max_new_tokens=2)]))
    assert len(deltas) == 1 and deltas[0].done and deltas[0].tokens == []
    assert deltas[0].response.finish_reason == FINISH_ERROR

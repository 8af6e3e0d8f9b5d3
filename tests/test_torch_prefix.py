"""The port's prefix cache and pools against the JAX package's, and the
whole port's streams against the JAX engine (``tests/test_paged.py``'s
cases).

- The whole port (its own model) against the JAX engine: the port's model
  rounds some float32 sums and transcendentals differently from XLA's
  (``tests/test_torch_families.py`` holds it to tolerances), so a sampled
  or near-tied greedy pick may part. Each stream equals JAX's up to its
  first divergence, and there the pick turns on one bf16 ulp of the
  logits (see :func:`_parts_on_one_ulp`); every greedy stream's first
  token (the prompt's whole prefill) agrees. internlm2 and granite agree
  on every stream.
- The prefix cache on and off: identical streams, JAX's hit counts, less
  prefill for the families that take it; the others decline it.
- The pools: batch and page axes of every family equal JAX's, the trie,
  refcounts, eviction and page defrag.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, smoke_config
from repro.kernels import registry as jregistry
from repro.models import init_cache as j_init_cache
from repro.models.transformer import (decode_step as j_decode_step,
                                      prefill_audio_cache as j_prefill_audio)
from repro.serve import (Engine as JEngine, PagedCachePool as JPagedPool,
                         Request as JRequest, SamplingParams as JSampling)
from repro.serve.sampling import (SlotSampling as JSlotSampling,
                                  sample_tokens as j_sample_tokens)
from repro_torch.models import decode_step, init_cache, prefill_audio_cache
from repro_torch.serve import (Engine, PagedCachePool, PageError,
                               PrefixCache, Request, SamplingParams)

from _torch_port import (ALL_FAMILY_ARCHS, engine_kw, family_setup,
                         jax_engine_streams, jax_model_in_port_engine,
                         port_engine_streams, serve_requests,
                         to_torch_config_arch)

MAX_LEN = 32


@functools.lru_cache(maxsize=None)
def _jax_decode(name):
    cfg, _, _, _ = family_setup(name)
    return jax.jit(lambda p, c, tok, pos: j_decode_step(p, cfg, c, tok,
                                                        positions=pos))


def _logits_after(name, req, toks, port):
    """The logits (V,) float32 the engine samples its next token from
    after ``req``'s prompt and ``toks``: the prompt and the tokens fed one
    a step at their positions, as the engine prefills, through JAX's
    model (its XLA route) or the port's, on a one-row slot cache."""
    cfg, tcfg, jp, tp = family_setup(name)
    max_len = engine_kw(cfg)["max_len"]
    enc_len = 16 if cfg.family == "audio" else None
    seq = list(req.prompt) + list(toks)
    if port:
        cache = init_cache(tcfg, 1, max_len, enc_len=enc_len)
        if enc_len:
            cache = prefill_audio_cache(tp, tcfg, cache, torch.from_numpy(
                req.enc_embeds)[None].to(torch.bfloat16))
        for i, tok in enumerate(seq):
            lg, cache = decode_step(
                tp, tcfg, cache, torch.tensor([[tok]], dtype=torch.int32),
                positions=torch.tensor([i], dtype=torch.int32))
        return lg[0, -1].float().numpy()
    with jregistry.use("xla"):
        cache = j_init_cache(cfg, 1, max_len, enc_len=enc_len)
        if enc_len:
            cache = j_prefill_audio(jp, cfg, cache, jnp.asarray(
                req.enc_embeds)[None].astype(jnp.bfloat16))
        for i, tok in enumerate(seq):
            lg, cache = _jax_decode(name)(
                jp, cache, jnp.asarray([[tok]], jnp.int32),
                jnp.asarray([i], jnp.int32))
    return np.asarray(lg[0, -1].astype(jnp.float32))


def _jax_pick(logits, req, t):
    """JAX's pick from bf16 ``logits`` at the request's t-th draw: the
    argmax, or ``repro.serve.sampling.sample_tokens`` with the request's
    policy and key ``fold_in(PRNGKey(seed), t)``."""
    lg = jnp.asarray(logits, jnp.bfloat16)[None]
    greedy = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    sp = req.sampling
    if sp is None:
        return int(greedy[0])
    samp = JSlotSampling(
        temperature=jnp.asarray([sp.temperature], jnp.float32),
        top_p=jnp.asarray([sp.top_p], jnp.float32),
        top_k=jnp.asarray([sp.top_k], jnp.int32),
        key=jnp.asarray([[sp.seed >> 32, sp.seed & 0xFFFFFFFF]], jnp.uint32))
    return int(j_sample_tokens(lg, greedy, samp,
                               jnp.asarray([t], jnp.int32))[0])


def _parts_on_one_ulp(lj, lp, req, t, token):
    """Whether JAX's pick at this step turns to the port's ``token`` on one
    bf16 ulp of JAX's logits ``lj``: with every logit moved one ulp toward
    the port's ``lp``, or with two logits within one ulp of each other
    among the ranks the policy can reach (the top-k, or all for greedy)
    ranked the other way round (their values exchanged; a tie broken
    against JAX's, by a ulp up for the later one)."""
    a = jnp.asarray(lj, jnp.bfloat16)
    if _jax_pick(np.asarray(jnp.nextafter(a, jnp.asarray(lp, jnp.bfloat16))
                            .astype(jnp.float32)), req, t) == token:
        return True
    up = np.asarray(jnp.nextafter(a, jnp.inf).astype(jnp.float32))
    top = req.sampling.top_k if req.sampling is not None else 2
    order = np.argsort(-lj, kind="stable")[:top + 1]
    for i, x in enumerate(order):
        for y in order[i + 1:]:
            if lj[x] - lj[y] > up[y] - lj[y]:
                continue                     # more than one ulp apart
            swapped = lj.copy()
            swapped[x], swapped[y] = lj[y], (up[y] if lj[x] == lj[y]
                                             else lj[x])
            if _jax_pick(swapped, req, t) == token:
                return True
    return False


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("name", ALL_FAMILY_ARCHS)
def test_port_streams_against_jax_engine(name, mode):
    """The whole port (its own model) on the paged pool: the slot pool's
    streams equal the paged pool's bit for bit; greedy, every stream's
    first token (the argmax after the prompt's whole prefill) equals JAX's;
    the families whose logits agree to the bit on these prompts
    (internlm2, granite) give JAX's streams whole, greedy and sampled.
    Elsewhere each stream equals JAX's up to its first divergence, and at
    that step (both models fed the common tokens) JAX's sampler picks
    JAX's token from JAX's logits and the port's token from the port's —
    the keys and the sampler agree, the logits part — and one bf16 ulp of
    JAX's logits turns its pick to the port's (:func:`_parts_on_one_ulp`).
    """
    sampled = mode == "sampled"
    got, _, _ = port_engine_streams(name, sampled, page_size=5)
    slot, _, _ = port_engine_streams(name, sampled)
    want = jax_engine_streams(name, sampled, page_size=5)
    assert got == slot
    if not sampled:
        assert all(got[r][:1] == want[r][:1] for r in want)
    same = sum(got[r] == want[r] for r in want)
    print(f"{name} {mode}: {same}/{len(want)} streams equal JAX's")
    if name in ("internlm2-1.8b", "granite-moe-1b-a400m"):
        assert got == want
    cfg = family_setup(name)[0]
    for req in serve_requests(JRequest, JSampling, cfg, sampled):
        g, w = got[req.id], want[req.id]
        assert len(g) == len(w)
        if g == w:
            continue
        t = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        lj = _logits_after(name, req, w[:t], port=False)
        lp = _logits_after(name, req, w[:t], port=True)
        assert _jax_pick(lj, req, t) == w[t], (req.id, t)
        assert _jax_pick(lp, req, t) == g[t], (req.id, t)
        assert _parts_on_one_ulp(lj, lp, req, t, g[t]), (req.id, t)


@pytest.mark.parametrize("name", ["internlm2-1.8b", "whisper-medium"])
def test_slot_pool_rounds_rows_to_whole_pages(name):
    """A slot pool whose max_len (20) is not a whole number of the decode's
    16-row slot pages holds 32 rows (whisper's admission row too), and its
    sampled streams equal the paged pool's at that max_len and the slot
    pool's at max_len 32."""
    cfg, tcfg, _, tp = family_setup(name)
    reqs = serve_requests(Request, SamplingParams, tcfg, sampled=True)
    kw = dict(engine_kw(cfg), max_len=20)
    runs = {}
    for page_size in (None, 5):
        eng = Engine(tp, tcfg, k=4, device="cpu", page_size=page_size, **kw)
        runs[page_size] = {r.id: list(r.tokens) for r in eng.run(reqs)}
        if page_size is None:
            assert eng.pool.make_cache()["layers"]["k"].shape[2] == 32
    assert runs[None] == runs[5] == port_engine_streams(name, True)[0]


@pytest.mark.parametrize("name", ALL_FAMILY_ARCHS)
def test_prefix_cache_streams_bit_identical(name):
    """Prefix reuse on vs off: identical streams, the JAX engine's hit and
    copy counts, less prefill for the families that take it (dense, vlm,
    moe); recurrent and enc-dec families decline it."""
    cfg, tcfg, jp, tp = family_setup(name)
    rng = np.random.RandomState(1)
    shared = rng.randint(0, cfg.vocab, size=6).tolist()
    encs = [rng.randn(16, cfg.d_model).astype(np.float32)
            if cfg.family == "audio" else None for _ in range(6)]

    def reqs(cls):
        return [cls(id=f"p{i}", prompt=shared + [i + 1], max_new_tokens=4,
                    enc_embeds=encs[i]) for i in range(6)]

    kw = dict(num_slots=2, max_len=MAX_LEN, k=2, max_prompt=8, page_size=4,
              enc_len=16 if cfg.family == "audio" else None)
    runs = {}
    for on in (False, True):
        with jregistry.use("xla"):
            jeng = JEngine(jp, cfg, prefix_cache=on, **kw)
            want = {r.id: r.tokens for r in jeng.run(reqs(JRequest))}
        with jax_model_in_port_engine(cfg, jp):
            eng = Engine(tp, tcfg, prefix_cache=on, device="cpu", **kw)
            got = {r.id: r.tokens for r in eng.run(reqs(Request))}
        assert got == want
        js, ts = jeng.stats, eng.stats
        assert (ts.prefix_hits, ts.prefix_tokens, ts.cow_copies,
                ts.prefill_tokens) == (js.prefix_hits, js.prefix_tokens,
                                       js.cow_copies, js.prefill_tokens)
        own = Engine(tp, tcfg, prefix_cache=on, device="cpu", **kw)
        runs[on] = ({r.id: r.tokens for r in own.run(reqs(Request))},
                    own.stats)
    assert runs[True][0] == runs[False][0]
    s_off, s_on = runs[False][1], runs[True][1]
    if cfg.family in ("dense", "vlm", "moe"):
        assert s_on.prefix_hits >= 4 and s_on.prefix_tokens >= 4 * 4
        assert s_on.prefill_tokens < s_off.prefill_tokens
    else:
        assert s_on.prefix_hits == 0 and s_on.prefix_tokens == 0


def test_prefix_cache_partial_page_copies_on_write():
    """A shared prefix that ends mid-page: the later requests map the whole
    pages, copy the partial one (copy-on-write) and skip every shared token;
    streams equal the cache-off run and, after the drain, the live pages are
    only the trie's."""
    name = "internlm2-1.8b"
    cfg, tcfg, _, tp = family_setup(name)
    rng = np.random.RandomState(2)
    shared = rng.randint(0, cfg.vocab, size=10).tolist()   # 2.5 pages of 4
    tails = [rng.randint(0, cfg.vocab, size=3).tolist() for _ in range(5)]
    reqs = [Request(id=f"q{i}", prompt=shared + t, max_new_tokens=3)
            for i, t in enumerate(tails)]
    runs = {}
    for on in (False, True):
        eng = Engine(tp, tcfg, num_slots=2, max_len=MAX_LEN, k=2,
                     max_prompt=16, page_size=4, prefix_cache=on,
                     device="cpu")
        # the first request alone publishes the shared pages
        first = eng.run(reqs[:1])
        rest = eng.run(reqs[1:])
        runs[on] = ({r.id: r.tokens for r in first + rest}, eng)
    assert runs[True][0] == runs[False][0]
    s, pool = runs[True][1].stats, runs[True][1].pool
    assert s.prefix_hits == 4 and s.prefix_tokens == 4 * 10
    assert s.cow_copies == 4
    ref = pool.refcounts()
    trie = {node.page for node in pool.prefix.iter_nodes()}
    live = set(int(p) for p in np.flatnonzero(ref[1:] > 0) + 1)
    assert live == trie and all(ref[p] == 1 for p in trie)


# --------------------------------------------------------------- the pools --
def _jax_axes(tree):
    if isinstance(tree, dict):
        return {k: _jax_axes(v) for k, v in tree.items()}
    return int(tree)


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("name", ALL_FAMILY_ARCHS)
def test_pool_axes_and_accounting_match_jax(name, kv):
    cfg, tcfg, _, _ = family_setup(name)
    enc = 16 if cfg.family == "audio" else None
    j = JPagedPool(cfg, 3, MAX_LEN, page_size=5, enc_len=enc, kv_dtype=kv)
    t = PagedCachePool(tcfg, 3, MAX_LEN, page_size=5, enc_len=enc,
                       kv_dtype=kv, device="cpu")
    assert t.has_paged == j.has_paged
    assert _jax_axes(j.batch_axes) == t.batch_axes
    assert _jax_axes(j.page_axes) == t.page_axes
    assert (t.num_pages, t.pages_per_slot) == (j.num_pages, j.pages_per_slot)
    if t.has_paged:
        assert t.page_bytes() == j.page_bytes()
    jc, tc = j.make_cache(), t.make_cache()
    jl = jax.tree.leaves(jc)             # leaves in sorted-key order

    def sorted_leaves(tree):
        return [x for k in sorted(tree) for x in (
            sorted_leaves(tree[k]) if isinstance(tree[k], dict)
            else [tree[k]])]
    tl = sorted_leaves(tc)
    assert [tuple(x.shape) for x in jl] == [tuple(x.shape) for x in tl]
    assert [str(x.dtype) for x in jl] == [str(x.dtype).split(".")[1]
                                          for x in tl]


def test_prefix_trie_match_insert_evict():
    trie = PrefixCache(page_size=4)
    c1, c2 = (1, 2, 3, 4), (5, 6, 7, 8)
    assert trie.insert_path([c1, c2], [7, 9]) == [7, 9]
    assert trie.insert_path([c1, c2], [7, 9]) == []
    full, partial = trie.match([1, 2, 3, 4, 5, 6, 99])
    assert full == [7] and partial == (9, 2)
    assert trie.evict_lru() == 9
    assert trie.evict_lru() == 7
    assert trie.evict_lru() is None


def test_prefix_match_touches_only_the_winning_partial():
    trie = PrefixCache(page_size=4)
    trie.insert_path([(1, 2, 3, 4)], [7])
    trie.insert_path([(1, 2, 8, 8)], [9])
    trie.insert_path([(5, 6, 7, 8)], [8])
    full, partial = trie.match([1, 2, 8, 9])
    assert full == [] and partial == (9, 3)
    assert trie.evict_lru() == 7


CFG_TINY = to_torch_config_arch(smoke_config(get_arch("internlm2-1.8b")))


def test_exhaustion_with_slot_held_pages_fails_fast_keeping_trie():
    pool = PagedCachePool(CFG_TINY, 2, 8, page_size=4, num_pages=3,
                          device="cpu")
    a = pool.allocate("a")
    pool.reserve(a, 8)
    pool.register_prefix(a, [1, 2, 3, 4, 5, 6, 7, 8], written_len=8)
    assert pool.prefix.n_nodes == 2 and pool.free_page_count == 0
    b = pool.allocate("b")
    with pytest.raises(PageError):
        pool.reserve(b, 4)
    assert pool.prefix.n_nodes == 2
    pool.free(a)
    pool.reserve(b, 8)
    assert pool.prefix.n_nodes == 0


def test_paged_pool_refcounts_across_retire_prefix_and_defrag():
    """tests/test_paged.py's case: pages live while a table or trie node
    holds them, a partial match copies on write, and page defrag keeps what
    each table sees."""
    pool = PagedCachePool(CFG_TINY, 3, 16, page_size=4, device="cpu")
    cache = pool.make_cache()
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    a = pool.allocate("a")
    pool.reserve(a, 9)
    assert pool.register_prefix(a, prompt, written_len=8) == 2
    shared = [int(pool.tables[a, i]) for i in range(2)]
    assert all(pool._ref[p] == 2 for p in shared)
    pool.free(a)
    assert all(pool._ref[p] == 1 for p in shared)
    assert np.all(pool.tables[a] == 0)
    b = pool.allocate("b")
    assert pool.map_prefix(b, prompt + [99]) == (8, None)
    assert [int(pool.tables[b, i]) for i in range(2)] == shared
    c = pool.allocate("c")
    m, cow = pool.map_prefix(c, prompt[:6] + [55, 66, 77])
    assert m == 6 and cow is not None
    src, dst = cow
    assert src == shared[1] and dst not in shared
    assert pool._ref[dst] == 1 and pool._ref[src] == 2
    # the copy moves page src's rows into dst in every paged leaf
    cache["layers"]["k"][:, src] = 3.0
    cache = pool.copy_page(cache, src, dst)
    assert bool((cache["layers"]["k"][:, dst] == 3.0).all())
    pool.free(b)
    pg = pool.prefix.evict_lru()
    assert pg == shared[1]
    pool._decref(pg)
    assert pool.page_fragmentation() > 0.0
    for name, leaf in cache["layers"].items():
        n = leaf.shape[1]
        leaf.copy_(torch.arange(n, dtype=leaf.dtype).reshape(
            1, n, *([1] * (leaf.dim() - 2))).expand_as(leaf))
    before = pool.tables[c].copy()
    cache = pool.defrag_pages(cache)
    assert pool.page_fragmentation() == 0.0
    got = cache["layers"]["k"][0, :, 0, 0, 0].float().numpy()
    np.testing.assert_array_equal(got[pool.tables[c]], before)
    pool.free(c)
    assert pool.live_page_count() == 1


def test_page_pool_exhaustion_evicts_then_raises():
    pool = PagedCachePool(CFG_TINY, 2, 8, page_size=4, num_pages=3,
                          device="cpu")
    a = pool.allocate("a")
    pool.reserve(a, 8)
    pool.register_prefix(a, [1, 2, 3, 4, 5, 6, 7, 8], written_len=8)
    pool.free(a)
    assert pool.free_page_count == 0
    b = pool.allocate("b")
    pool.reserve(b, 8)
    assert pool.prefix.n_nodes == 0
    c = pool.allocate("c")
    with pytest.raises(PageError):
        pool.reserve(c, 4)

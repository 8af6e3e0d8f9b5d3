"""Sharded serving on the model axis, on the CPU: JAX's ``cache_specs`` on
the port's pools, ``paged_decode`` over one rank's rows with its lse and
the merge across ranks, and the dense family's engine tensor-parallel in
spawned gloo ranks (one spawn of four: every case at world 4, then at
world 2 on each pair of them) against the JAX package's single-device
engine.

- ``cache_specs`` leaf for leaf against JAX's for every family's
  ``init_cache`` and paged pool (bf16 and int8), on (1, 2), (2, 2),
  (1, 4) and JAX's production meshes (shapes only, no process group).
- The row-sliced plain versions (``ref.paged_decode``, the Pallas
  kernel's arithmetic, and ``ref.paged_decode_gathered``, the op's CPU
  route) over m slices of every page's rows, merged by
  ``ref.merge_partials``, against JAX's ``paged_flash_decode`` in
  interpret mode and the unsplit plain version: float32 outputs at the
  kernel tests' ``ATTN_TOL``, bf16 ones within one bf16 ulp of the
  unsplit version (``BF16_TOL``); int8 pages, a page size the axis does
  not divide (the rows stay whole: no split), valid lengths that end
  inside a rank's rows.
- ``Engine(params, cfg, rules=make_rules(Mesh(("data", "model"), (1,
  m)), group))`` on internlm2's smoke config (4 query and 2 kv heads, so
  the kv heads do not divide 4), its weights carried from JAX's
  ``init_params`` by ``models/convert.py``: greedy, sampled, n = 2
  fan-out, the slot pool, bf16 and int8 pages, a page of 6 (whole on
  each of 4 ranks, split 3/3 over 2), the prefix cache with
  copy-on-write, and the double-buffered loop at world 2. Every rank
  returns the same responses; each stream equals the JAX engine's up to
  its first divergence, and there one bf16 ulp of JAX's logits turns
  JAX's pick to the port's (``test_torch_prefix._parts_on_one_ulp``, the
  logits of both models fed the common tokens, the port's on the mesh);
  the prefix hits, skipped tokens and copies equal JAX's.
- Each rank's pool: its shape, its row slice and its bytes (the single
  card's over m).
- The collectives of a decode step, counted by DTensor's
  ``CommDebugMode``, against the count the weights' specs give.
- The refusals, each naming its ROADMAP item.

Both packages' ``_MIN_SHARD_BYTES_ELEMS`` are lowered to 128 elements in
the ranks, so the smoke config's weights split over the model axis as a
full config's do.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.dist.compat import spoof_mesh
from repro.dist.sharding import cache_specs as j_cache_specs
from repro.dist.sharding import make_rules as j_make_rules
from repro.kernels import registry as jregistry
from repro.kernels.flash_attention import ops as jfa_ops
from repro.models import init_cache as j_init_cache
from repro.models.transformer import decode_step as j_decode_step
from repro.serve import (Engine as JEngine, PagedCachePool as JPagedPool,
                         Request as JRequest, SamplingParams as JSampling)
from repro_torch.dist import Mesh, cache_specs
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import init_cache
from repro_torch.serve import PagedCachePool
from repro_torch.serve.sampling import fold_in_seed

from _torch_port import (ALL_FAMILY_ARCHS, family_setup, spawn_gloo,
                         to_torch_config_arch)
from test_torch_prefix import _jax_pick, _parts_on_one_ulp

NAME = "internlm2-1.8b"
MESHES = [((1, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
#: tests/test_torch_kernels.py's tolerances
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=8e-3, atol=8e-3)
MAX_LEN = 32
SAMPLING = dict(temperature=0.8, top_p=0.9, top_k=8)
ENGINE_KW = dict(num_slots=3, max_len=MAX_LEN, k=2, max_prompt=16,
                 prefix_cache=True)
#: the engine cases: (page size, kv dtype); None: the slot pool
CASES = {"slot": (None, "f32"), "paged4": (4, "f32"), "int8": (4, "int8"),
         "paged6": (6, "f32")}
MIN_SHARD = 128


def _specs(tree):
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _specs(tree[k])]
    return [tuple(tree)]


def _jspecs(tree):
    from jax.sharding import PartitionSpec as P
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


# ------------------------------------------------------- cache specs ---
@pytest.mark.parametrize("name", ALL_FAMILY_ARCHS)
def test_cache_specs_equal_jax_on_every_pool(name):
    """The decode cache (``init_cache``) and the paged pool, bf16 and int8
    pages of 16 rows, of each family's smoke config: the same spec for
    every leaf on every mesh."""
    from repro_torch.dist import make_rules
    cfg = jconfigs.smoke_config(jconfigs.get_arch(name))
    tcfg = to_torch_config_arch(cfg)
    enc = 16 if cfg.family == "audio" else None
    trees = [(jax.eval_shape(lambda: j_init_cache(cfg, 32, 64,
                                                  enc_len=enc)),
              init_cache(tcfg, 32, 64, device="meta", enc_len=enc))]
    for kv in ("f32", "int8"):
        jpool = JPagedPool(cfg, 4, 64, page_size=16, enc_len=enc,
                           kv_dtype=kv)
        pool = PagedCachePool(tcfg, 4, 64, page_size=16, enc_len=enc,
                              kv_dtype=kv, device="cpu")
        trees.append((jax.eval_shape(jpool.make_cache),
                      pool._pool_arrays("meta")))
    for sizes, names in MESHES:
        jrules = j_make_rules(spoof_mesh(sizes, names))
        rules = make_rules(Mesh(names, sizes))
        for jtree, tree in trees:
            jspec, spec = j_cache_specs(jtree, jrules), cache_specs(tree,
                                                                     rules)
            assert sorted(spec) == sorted(jspec)
            for key in jspec:
                assert _specs(spec[key]) == _jspecs(jspec[key]), \
                    (sizes, key)


# ------------------------------------------ row-sliced paged decode ---
def _pool(B, Hq, Hkv, D, P, npages, kv, lens, seed):
    rng = np.random.default_rng(seed)
    num_pages = 1 + B * npages
    valid = np.asarray(lens, np.int32)
    perm = rng.permutation(np.arange(1, num_pages)).reshape(B, npages)
    table = np.where(np.arange(npages)[None] < -(-valid // P)[:, None],
                     perm, 0).astype(np.int32)
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    shape = (num_pages, P, Hkv, D)
    scales = {}
    if kv == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        scales = {n: rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32)
                  for n in ("k_scale", "v_scale")}
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, table, valid, scales


def _split(fn, q, k, v, table, valid, scales, m):
    """fn over each of m ranks' rows of every page, merged; the ranks'
    lse beside. A page size m does not divide stays whole: one rank."""
    P = k.shape[1]
    if P % m:
        return fn(q, k, v, table, valid, **scales), None
    R = P // m
    outs, lses = [], []
    for r in range(m):
        cut = slice(r * R, (r + 1) * R)
        sl = {n: t[:, cut].contiguous() for n, t in scales.items()}
        o, lse = fn(q, k[:, cut].contiguous(), v[:, cut].contiguous(),
                    table, valid, **sl, row_base=r * R, row_stride=P,
                    return_lse=True)
        outs.append(o)
        lses.append(lse)
    return fa_ref.merge_partials(torch.stack(outs), torch.stack(lses)), \
        torch.stack(lses)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("kv,P", [("f32", 16), ("int8", 16), ("bf16", 16),
                                  ("f32", 6)])
def test_row_sliced_paged_decode_merges_to_the_unsplit(kv, P, m):
    """m slices of each page's rows, merged: the Pallas kernel (interpret
    mode) and the unsplit plain version; the lse's logsumexp over the
    ranks is the unsplit lse; a rank none of whose rows is valid for a
    row has lse -inf. Lengths 1, 5, 17, 23 and 64 end inside a rank's
    rows (and the first two inside rank 0's)."""
    B, Hq, Hkv, D, npages = 5, 8, 2, 16, 4
    lens = [1, 5, 17, 23, 64]
    q, k, v, table, valid, scales = _pool(B, Hq, Hkv, D, P, npages,
                                          "int8" if kv == "int8" else "f32",
                                          lens, seed=m)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))   # noqa: E731
    args = [t(q), t(k), t(v), t(table), t(valid)]
    if kv == "bf16":
        args[:3] = [a.bfloat16() for a in args[:3]]
    ts = {n: t(a) for n, a in scales.items()}
    for fn in (fa_ref.paged_decode, fa_ref.paged_decode_gathered):
        whole, lse = fn(*args, **ts, return_lse=True)
        assert torch.equal(whole, fn(*args, **ts))
        got, lses = _split(fn, *args, ts, m)
        if kv == "bf16":
            np.testing.assert_allclose(got.float().numpy(),
                                       whole.float().numpy(), **BF16_TOL)
        else:
            np.testing.assert_allclose(got.numpy(), whole.numpy(),
                                       **ATTN_TOL)
        if lses is not None:
            np.testing.assert_allclose(torch.logsumexp(lses, 0).numpy(),
                                       lse.numpy(), **ATTN_TOL)
            # row 0 (valid 1) sees only rank 0's first row
            assert torch.isinf(lses[1:, 0]).all() and \
                torch.isfinite(lses[0, 0]).all()
        else:
            assert P % m
    # JAX's Pallas kernel on the whole pool
    jq = jnp.asarray(args[0].float().numpy())
    jkv = [jnp.asarray(a.float().numpy()) for a in args[1:3]]
    if kv == "bf16":
        jq, jkv = jq.astype(jnp.bfloat16), [a.astype(jnp.bfloat16)
                                            for a in jkv]
    elif kv == "int8":
        jkv = [jnp.asarray(a) for a in (k, v)]
    want = jfa_ops.paged_flash_decode(
        jq, *jkv, jnp.asarray(table), jnp.asarray(valid),
        **{n: jnp.asarray(a) for n, a in scales.items()}, interpret=True)
    got, _ = _split(fa_ref.paged_decode, *args, ts, m)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(BF16_TOL if kv == "bf16" else ATTN_TOL))


@pytest.mark.parametrize("chunk_bytes", [1, 24, 1 << 28])
def test_compaction_moves_live_entries_by_chunks(chunk_bytes, monkeypatch):
    """``serve.cache.compact`` (the pools' defrag, which a 128 GiB pool has
    no room to copy whole): the live entries land in front as the whole
    leaf's ``index_select`` would put them, through temporaries of one,
    two or all entries."""
    from repro_torch.serve import cache as tcache
    monkeypatch.setattr(tcache, "_COMPACT_BYTES", chunk_bytes)
    leaf = torch.arange(2 * 9 * 3, dtype=torch.float32).reshape(2, 9, 3)
    live = [0, 2, 3, 7, 8]
    perm = torch.tensor(live + [1, 4, 5, 6])
    want = leaf.index_select(1, perm)
    tcache.compact(leaf, 1, perm, len(live))
    assert torch.equal(leaf[:, :len(live)], want[:, :len(live)])


# ---------------------------------------------------- the engine ---
def _request_specs():
    """(first, rest) as (id, prompt, max new tokens, sampling seed or
    None, n): a shared prefix that ends mid-page (copy-on-write at page
    4), greedy, sampled and a fan-out of 2, then short prompts; ``first``
    runs alone, publishing the shared pages."""
    rng = np.random.RandomState(2)
    shared = rng.randint(0, 256, size=10).tolist()
    tails = [rng.randint(0, 256, size=3).tolist() for _ in range(4)]
    first = [("q0", shared + tails[0], 4, None, 1)]
    rest = [("q1", shared + tails[1], 5, None, 1),
            ("q2", shared + tails[2], 5, 2, 1),
            ("q3", shared + tails[3], 5, 3, 2),
            ("q4", [7], 6, None, 1),
            ("q5", [3, 11, 5], 6, 5, 1)]
    return first, rest


def _requests(cls, scls, specs=None, sampling=SAMPLING):
    """Either package's requests from :func:`_request_specs`."""
    return [[cls(id=i, prompt=list(pr), max_new_tokens=mx, n=n,
                 sampling=None if seed is None
                 else scls(**sampling, seed=seed))
             for i, pr, mx, seed, n in part]
            for part in (specs or _request_specs())]


def _streams(out):
    return {f"{r.id}/{r.stream}": list(r.tokens) for r in out}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX engine's streams and prefix counts at pages of 4, bf16 and
    int8 (its slot and paged streams are the same bits on its XLA
    route)."""
    cfg, _, jp, _ = family_setup(NAME)
    out = {}
    for kv in ("f32", "int8"):
        with jregistry.use("xla"):
            eng = JEngine(jp, cfg, page_size=4, kv_dtype=kv, **ENGINE_KW)
            first, rest = _requests(JRequest, JSampling)
            res = eng.run(first) + eng.run(rest)
        s = eng.stats
        out[kv] = (_streams(res), (s.prefix_hits, s.prefix_tokens,
                                   s.cow_copies))
    return out


#: each spawned rank: every case of its world; it imports torch and
#: repro_torch only
_JOB = r"""
import numpy as np
import torch
import torch.distributed as dist
import repro_torch.dist.sharding as sharding
from repro_torch import Unsupported
from repro_torch.configs import get_arch, smoke_config
from repro_torch.dist import DeadlineGate, Mesh, cache_shard, make_rules
from repro_torch.launch.steps import make_serve_step, serve_params
from repro_torch.serve import (CachePool, Engine, PagedCachePool, Request,
                               SamplingParams, Scheduler)
from torch.distributed.tensor.debug import CommDebugMode


def requests():
    return [[Request(id=i, prompt=list(pr), max_new_tokens=mx, n=n,
                     sampling=None if seed is None else
                     SamplingParams(**p["sampling"], seed=seed))
             for i, pr, mx, seed, n in part] for part in p["requests"]]


def streams(out):
    return {f"{r.id}/{r.stream}": list(r.tokens) for r in out}


def run(params, cfg, rules, page, kv, overlap=False):
    eng = Engine(params, cfg, page_size=page, kv_dtype=kv, device="cpu",
                 rules=rules, overlap=overlap, **p["kw"])
    first, rest = requests()
    res = eng.run(first) + eng.run(rest)
    s = eng.stats
    return eng, dict(streams=streams(res),
                     prefix=(s.prefix_hits, s.prefix_tokens, s.cow_copies),
                     gathers=eng.collectives.all_gathers, steps=s.steps)


def logits_after(params, cfg, rules, seq, page, kv):
    # the logits the engine picks from after ``seq``, fed one token a step
    # into a one-slot pool of the case's layout
    pool = (PagedCachePool(cfg, 1, p["kw"]["max_len"], page_size=page,
                           kv_dtype=kv, device="cpu", rules=rules)
            if page else CachePool(cfg, 1, p["kw"]["max_len"],
                                   device="cpu", rules=rules))
    cache = pool.make_cache()
    slot = pool.allocate("x")
    table = None
    if page:
        pool.reserve(slot, len(seq))
        table = torch.from_numpy(pool.tables.copy())
    serve = make_serve_step(cfg, rules, kv_rows=page or pool.rows)
    for i, tok in enumerate(seq):
        _, lg, cache = serve(params, cache,
                             torch.tensor([[tok]], dtype=torch.int32),
                             torch.tensor([i], dtype=torch.int32), table)
    return lg[0, -1].float()


def refusal(fn):
    try:
        fn()
    except Unsupported as e:
        return str(e)
    return None


def run_world(group, world):
    # every case of a world, on ``group``'s ``world`` ranks
    cfg = smoke_config(get_arch(p["name"]))
    rules = make_rules(Mesh(("data", "model"), (1, world)), group)
    params = serve_params(cfg, p["params"], rules)
    out = {}
    prompts = {}
    first, rest = requests()
    for r in first + rest:
        prompts[r.id] = list(r.prompt)
    for case, (page, kv) in p["cases"].items():
        eng, rec = run(params, cfg, rules, page, kv)
        cache = eng.pool.make_cache()
        k = cache["layers"]["k"]
        rows = page or eng.pool.rows
        rec["k_shape"] = tuple(k.shape)
        rec["pool_bytes"] = (eng.pool.page_bytes() * eng.pool.num_pages
                             if page else
                             sum(t.numel() * t.element_size()
                                 for t in (cache["layers"]["k"],
                                           cache["layers"]["v"])))
        kshape = (cfg.n_layers, eng.pool.num_pages, page,
                  cfg.n_kv_heads, cfg.head_dim) if page else \
            (cfg.n_layers, eng.pool.num_slots, rows, cfg.n_kv_heads,
             cfg.head_dim)
        sh = cache_shard("k", kshape, rules)
        rec["shard"] = (sh.local, sh.start, sh.stride, sh.split)
        want = p["jax"][kv]
        parted = {}
        for key, toks in rec["streams"].items():
            w = want.get(key)
            if w is None or w == toks:
                continue
            t = next(i for i, (a, b) in enumerate(zip(toks, w)) if a != b)
            rid = key.split("/")[0]
            parted[key] = (t, logits_after(params, cfg, rules,
                                           prompts[rid] + w[:t], page, kv))
        rec["parted"] = parted
        out[case] = rec
    if world == 2:
        _, rec = run(params, cfg, rules, 4, "f32", overlap=True)
        out["overlap"] = rec
    # the collectives of one k = 1 step of the paged engine
    eng = Engine(params, cfg, num_slots=3, max_len=32, max_prompt=8, k=1,
                 device="cpu", page_size=4, rules=rules)
    eng.submit(Request(id="c", prompt=[1, 2, 3], max_new_tokens=4))
    eng.step()
    before = eng.collectives.all_gathers
    with CommDebugMode() as comm:
        eng.step()
    out["comm"] = ({str(k): v for k, v in comm.get_comm_counts().items()},
                   eng.collectives.all_gathers - before)
    # the refusals
    moe = smoke_config(get_arch("granite-moe-1b-a400m"))
    data = make_rules(Mesh(("data", "model"), (world, 1)), group)
    out["refused"] = dict(
        moe_step=refusal(lambda: make_serve_step(moe, rules, kv_rows=32)),
        moe_engine=refusal(lambda: Engine(p["params"], moe, device="cpu",
                                          page_size=4, rules=rules)),
        data_engine=refusal(lambda: Engine(p["params"], cfg, device="cpu",
                                           page_size=4, rules=data)),
        data_paged=refusal(lambda: make_serve_step(cfg, data)(
            p["params"], None, torch.zeros(1, 1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, 1, dtype=torch.int32))),
        gate=refusal(lambda: Engine(
            params, cfg, device="cpu", page_size=4, rules=rules,
            scheduler=Scheduler(gate=DeadlineGate(1.0)))))
    return out


def main(rank, world, p_):
    # world 4 on all ranks, then world 2 on each pair of them at once
    global p
    p = p_
    sharding._MIN_SHARD_BYTES_ELEMS = p["min_shard"]
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    out = {4: run_world(dist.group.WORLD, 4)}
    out[2] = run_world(pairs[rank // 2], 2)
    return out
"""


@pytest.fixture(scope="module")
def spawned(jax_ref, tmp_path_factory):
    """One spawn of four gloo ranks: every case at world 4, then at
    world 2 on ranks (0, 1) and (2, 3) at once. {world: each rank's
    result, in rank order}: world 2's rank i is rank i % 2 of its pair."""
    _, _, _, tparams = family_setup(NAME)
    payload = dict(name=NAME, params=tparams, min_shard=MIN_SHARD,
                   kw=ENGINE_KW, cases=CASES, sampling=SAMPLING,
                   requests=_request_specs(),
                   jax={kv: s for kv, (s, _) in jax_ref.items()})
    ranks = spawn_gloo(4, _JOB, payload, tmp_path_factory.mktemp("tp") /
                       "job", timeout=240)
    return {w: [r[w] for r in ranks] for w in (2, 4)}


_JAX_STEPS: dict = {}


def _jax_logits(seq, kv):
    """JAX's logits after ``seq`` (its XLA route), fed one token a step as
    its engine prefills: a one-row slot cache (its bf16 engines' bits at
    any page size) or, int8, a one-slot pool of int8 pages of 4."""
    cfg, _, jp, _ = family_setup(NAME)
    if kv not in _JAX_STEPS:
        _JAX_STEPS[kv] = jax.jit(
            lambda p, c, tok, pos, tbl: j_decode_step(
                p, cfg, c, tok, positions=pos, page_table=tbl))
    with jregistry.use("xla"):
        table = None
        if kv == "f32":
            cache = j_init_cache(cfg, 1, MAX_LEN)
        else:
            pool = JPagedPool(cfg, 1, MAX_LEN, page_size=4, kv_dtype=kv)
            cache = pool.make_cache()
            pool.reserve(pool.allocate("x"), len(seq))
            table = jnp.asarray(pool.tables)
        for i, tok in enumerate(seq):
            lg, cache = _JAX_STEPS[kv](jp, cache,
                                       jnp.asarray([[tok]], jnp.int32),
                                       jnp.asarray([i], jnp.int32), table)
    return np.asarray(lg[0, -1].astype(jnp.float32))


def _stand_in(req, stream):
    """What ``_jax_pick`` reads of a request for one of its streams: its
    policy, a fan-out stream's seed folded in as the engine derives its
    key."""
    sp = req.sampling
    if sp is not None and (req.n or 1) > 1:
        sp = JSampling(temperature=sp.temperature, top_p=sp.top_p,
                       top_k=sp.top_k, seed=fold_in_seed(sp.seed, stream))
    return types.SimpleNamespace(sampling=sp)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_engine_streams_against_jax(world, case, spawned,
                                            jax_ref):
    """Every rank the same streams; each equal to the JAX engine's up to
    its first divergence, and there JAX's pick turns to the port's on one
    bf16 ulp of JAX's logits, the port's pick on the mesh being the
    sharded model's own; the prefix counts of the paged cases JAX's."""
    recs = [r[case] for r in spawned[world]]
    assert all(r["streams"] == recs[0]["streams"] for r in recs)
    page, kv = CASES[case]
    want, prefix = jax_ref[kv]
    got = recs[0]["streams"]
    assert sorted(got) == sorted(want)
    if page is not None:
        assert recs[0]["prefix"] == prefix
        assert prefix[0] > 0 and prefix[2] > 0    # hits and copies
    reqs = {r.id: r for part in _requests(JRequest, JSampling)
            for r in part}
    same = sum(got[key] == want[key] for key in want)
    print(f"world {world} {case}: {same}/{len(want)} streams equal JAX's")
    for key, toks in got.items():
        w = want[key]
        assert len(toks) == len(w), key
        if toks == w:
            continue
        t, lp = recs[0]["parted"][key]
        rid, stream = key.split("/")
        req = _stand_in(reqs[rid], int(stream))
        lj = _jax_logits(list(reqs[rid].prompt) + w[:t], kv)
        lp = lp.numpy()
        assert _jax_pick(lj, req, t) == w[t], (key, t)
        assert _jax_pick(lp, req, t) == toks[t], (key, t)
        assert _parts_on_one_ulp(lj, lp, req, t, toks[t]), (key, t)


def test_overlap_streams_equal_the_blocking_loop(spawned):
    """The double-buffered loop on the mesh: the blocking loop's streams,
    bit for bit, on every rank."""
    for r in spawned[2]:
        assert r["overlap"]["streams"] == r["paged4"]["streams"]
        assert r["overlap"]["prefix"] == r["paged4"]["prefix"]


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_its_rows(world, spawned):
    """The pool of each rank: its K/V shape (a page's rows over m, or
    whole where m does not divide them; the slot pool's rows, rounded to
    16 a rank, over m), its slice of the rows, and its bytes, the single
    card's over m where the rows split."""
    ranks = spawned[world]
    for case, (page, kv) in CASES.items():
        split = page is None or page % world == 0
        rows = page if page else -(-MAX_LEN // (16 * world)) * 16 * world
        for i, r in enumerate(ranks):
            rank = i % world
            local, start, stride, is_split = r[case]["shard"]
            assert is_split == split
            assert stride == rows
            per = rows // world if split else rows
            assert local[2] == per and r[case]["k_shape"][2] == per
            assert start == (rank * per if split else 0)
            assert r[case]["k_shape"] == tuple(local)
        bytes_ = [r[case]["pool_bytes"] for r in ranks]
        assert len(set(bytes_)) == 1
        if page is not None:
            pool = PagedCachePool(family_setup(NAME)[1], 3, MAX_LEN,
                                  page_size=page, kv_dtype=kv, device="cpu")
            single = pool.page_bytes() * pool.num_pages
            assert bytes_[0] * (world if split else 1) == single


@pytest.mark.parametrize("world", [2, 4])
def test_decode_step_collectives(world, spawned):
    """One decode step on the mesh (k = 1): per layer one gather of the
    (o, lse) partials (counted by the engine too), the replication of q,
    k and v (an all_gather a column-parallel projection, an all_reduce a
    row-parallel one), wo's, w_down's all_reduce and the two norm gains'
    all_gathers; then the embedding's all_reduce and the logits'
    all_gather: as the weights' specs on the model axis give them."""
    import repro_torch.dist.sharding as sharding
    from repro_torch.dist import make_rules
    from repro_torch.dist.sharding import param_specs
    from repro_torch.models import init_params
    counts, merges = spawned[world][0]["comm"]
    tcfg = family_setup(NAME)[1]
    mp = pytest.MonkeyPatch()
    mp.setattr(sharding, "_MIN_SHARD_BYTES_ELEMS", MIN_SHARD)
    try:
        spec = param_specs(init_params(tcfg, None, device="meta"),
                           make_rules(Mesh(("data", "model"), (1, world))),
                           gather_fsdp=True)
    finally:
        mp.undo()
    lay = spec["layers"]

    def col(s):        # split on the output dim: its product gathers
        return s[-1] == "model"

    def row(s):        # split on the input dim: its product reduces
        return s[-2] == "model"
    L = tcfg.n_layers
    gathers = L * (sum(col(lay["attn"][w]) for w in ("wq", "wk", "wv",
                                                      "wo"))
                   + sum("model" in lay[g] for g in ("ln1", "ln2"))) \
        + col(spec["lm_head"]) + ("model" in spec["ln_f"])
    reduces = L * (sum(row(lay["attn"][w]) for w in ("wq", "wk", "wv",
                                                      "wo"))
                   + row(lay["mlp"]["w_down"])) + (spec["embed"][0] ==
                                                  "model")
    assert merges == L
    assert counts == {"c10d_functional.all_gather_into_tensor": gathers,
                      "c10d_functional.all_reduce": reduces,
                      "c10d._allgather_base_": L}


@pytest.mark.parametrize("world", [2, 4])
def test_refusals_name_their_item(world, spawned):
    refused = spawned[world][0]["refused"]
    for what, item in (("moe_step", "7(a)"), ("moe_engine", "7(a)"),
                       ("data_engine", "7(d)"), ("data_paged", "7(d)"),
                       ("gate", "7(d)")):
        assert refused[what] is not None, what
        assert f"queue 1 item {item}" in refused[what], (what,
                                                         refused[what])

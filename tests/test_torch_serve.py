"""The port's serving stack against the JAX package's: greedy token streams
of ``repro_torch.serve.Engine`` equal the JAX ``Engine``'s (its auto
backend on the CPU) over the slot pool, the paged pool (page size 5) and
int8 pages at k in {1, 4}; the port's paged streams equal its slot
streams; the serve regressions of the JAX suite; page refcounts; the
options of the rest of serving (sampling, fan-out, the prefix cache,
overlap, every family) served and the JAX engine's refusals kept; and the
CLI with every flag. Sampling, fan-out, paging, the prefix cache and
overlap against the JAX engine are in tests/test_torch_sampling.py,
test_torch_fanout.py, test_torch_paged.py and test_torch_overlap.py."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch, smoke_config
from repro.models import init_params as j_init_params
from repro.serve import (Engine as JEngine, PagedCachePool as JPagedCachePool,
                         Request as JRequest)
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.dist import DeadlineGate
from repro_torch.launch import serve as serve_cli
from repro_torch.models import forward, init_params
from repro_torch.serve import (CachePool, Engine, FINISH_EOS, FINISH_ERROR,
                               FINISH_LENGTH, PagedCachePool, PageError,
                               Request, SamplingParams, Scheduler)

from _torch_port import to_torch_config_arch, to_torch_params

CFG = smoke_config(get_arch("internlm2-1.8b"))
TCFG = to_torch_config_arch(CFG)
PROMPTS = [[7], [3, 11, 5], [9, 2], [4, 4, 4, 8], [13]]
N_NEW = 6
MODES = {"slot": {}, "paged": dict(page_size=5),
         "int8": dict(page_size=5, kv_dtype="int8")}


@functools.lru_cache(maxsize=None)
def _weights():
    params = j_init_params(CFG, jax.random.PRNGKey(0))
    return params, to_torch_params(params, CFG)


def _requests(cls):
    return [cls(id=f"r{i}", prompt=p, max_new_tokens=N_NEW)
            for i, p in enumerate(PROMPTS)]


@functools.lru_cache(maxsize=None)
def _jax_streams(mode, k):
    """The JAX engine's streams, built once per module and (mode, k)."""
    eng = JEngine(_weights()[0], CFG, num_slots=3, max_len=32, k=k,
                  **MODES[mode])
    return {r.id: r.tokens for r in eng.run(_requests(JRequest))}


def _port(mode, k, **kw):
    eng = Engine(_weights()[1], TCFG, num_slots=3, max_len=32, k=k,
                 device="cpu", **MODES[mode], **kw)
    out = eng.run(_requests(Request))
    return eng, {r.id: r.tokens for r in out}, out


def _min_margin(streams):
    """Smallest top-1 minus top-2 logit over every generated token, by the
    port's teacher-forced forward: how near a tie the closest pick was."""
    params = _weights()[1]
    margin = float("inf")
    for i, p in enumerate(PROMPTS):
        seq = p + streams[f"r{i}"]
        logits, _ = forward(params, TCFG,
                            {"tokens": torch.tensor([seq], dtype=torch.int32)})
        top = logits[0, len(p) - 1:len(seq) - 1].float().topk(2, dim=-1)
        margin = min(margin, float((top.values[:, 0] - top.values[:, 1])
                                   .min()))
    return margin


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_engine_streams_match_jax(mode, k):
    eng, got, out = _port(mode, k)
    want = _jax_streams(mode, k)
    print(f"{mode} k={k}: smallest top-1/top-2 logit margin "
          f"{_min_margin(got):.4f}")
    assert got == want
    s = eng.stats
    assert s.steps == s.syncs * k and s.retired == len(PROMPTS)
    assert s.tokens_out == N_NEW * len(PROMPTS)
    assert all(r.finish_reason == FINISH_LENGTH for r in out)


@pytest.mark.parametrize("k", [1, 4])
def test_paged_streams_equal_slot_streams(k):
    assert _port("paged", k)[1] == _port("slot", k)[1]


def test_stream_yields_the_run_tokens():
    eng = Engine(_weights()[1], TCFG, num_slots=2, max_len=32, k=3,
                 device="cpu", page_size=5)
    got = {}
    for d in eng.stream(_requests(Request)):
        got.setdefault(d.id, []).extend(d.tokens)
        assert len(d.tokens) <= 3
        assert d.done == (d.response is not None)
    assert got == _port("slot", 1)[1]


def test_paged_pool_matches_jax_accounting():
    for kv in ("f32", "int8"):
        j = JPagedCachePool(CFG, 3, 32, page_size=5, kv_dtype=kv)
        t = PagedCachePool(TCFG, 3, 32, page_size=5, kv_dtype=kv,
                           device="cpu")
        assert (t.num_pages, t.pages_per_slot, t.page_bytes()) == \
            (j.num_pages, j.pages_per_slot, j.page_bytes())


# -------------------------------------------- regressions of the JAX suite --
def test_run_drains_in_exactly_max_syncs():
    eng = Engine(_weights()[1], TCFG, num_slots=1, max_len=16, k=2,
                 max_prompt=4, device="cpu")
    out = eng.run([Request(id="x", prompt=[1], max_new_tokens=4)],
                  max_syncs=2)
    assert len(out) == 1 and len(out[0].tokens) == 4
    assert eng.stats.syncs == 2


@pytest.mark.parametrize("page_size", [None, 5])
def test_finish_reason_from_device_done_branch(page_size):
    def run(eos_id, max_new):
        eng = Engine(_weights()[1], TCFG, num_slots=1, max_len=16, k=2,
                     max_prompt=4, eos_id=eos_id, page_size=page_size,
                     device="cpu")
        return eng.run([Request(id="x", prompt=[7],
                                max_new_tokens=max_new)])[0]

    t = run(None, 6).tokens                  # greedy reference stream
    r = run(int(t[0]), 1)                    # budget and eos fire together
    assert r.tokens == [t[0]] and r.finish_reason == FINISH_LENGTH
    r = run(int(t[0]), 6)                    # eos fires with budget to spare
    assert r.tokens == [t[0]] and r.finish_reason == FINISH_EOS


def test_scheduler_sheds_expired_under_light_load():
    sch = Scheduler(gate=DeadlineGate(deadline_s=1.0, quorum=0.5),
                    clock=lambda: 10.0)
    sch.submit(Request(id="stale", prompt=[1]), now=5.0)     # 5s past
    sch.submit(Request(id="fresh", prompt=[1]), now=9.9)
    admit, shed = sch.schedule(free_slots=4, now=10.0)
    assert [r.id for r in admit] == ["fresh"]
    assert [r.id for r in shed] == ["stale"]


def test_cachepool_free_heap_keeps_lowest_slot_first():
    pool = CachePool(TCFG, 8, 8, device="cpu")
    slots = [pool.allocate(f"r{i}") for i in range(8)]
    assert slots == list(range(8))
    order = [6, 1, 4, 3]
    for s in order:
        pool.free(s)
    assert [pool.allocate(f"q{i}") for i in range(4)] == sorted(order)


def test_overlong_prompt_is_rejected_without_a_slot():
    eng = Engine(_weights()[1], TCFG, num_slots=1, max_len=16, k=2,
                 max_prompt=4, device="cpu")
    out = eng.run([Request(id="long", prompt=[1] * 5, max_new_tokens=2),
                   Request(id="ok", prompt=[1], max_new_tokens=2)])
    reasons = {r.id: r.finish_reason for r in out}
    assert reasons == {"long": FINISH_ERROR, "ok": FINISH_LENGTH}
    assert eng.stats.rejected == 1


# ------------------------------------------------------------ page pool --
def test_page_refcounts_through_retire_and_defrag():
    pool = PagedCachePool(TCFG, 3, 20, page_size=5, device="cpu")
    cache = pool.make_cache()
    a, b, c = (pool.allocate(x) for x in "abc")
    for s, n in ((a, 7), (b, 12), (c, 3)):
        pool.reserve(s, n)
    assert pool.live_page_count() == 2 + 3 + 1
    # mark each slot's pages with its own value, then free b
    for s in (a, c):
        for pg in pool.tables[s][:int(pool._n_pages[s])]:
            cache["layers"]["k"][:, pg] = float(s + 1)
    pool.free(b)
    assert pool.live_page_count() == 3
    assert (pool.tables[b] == 0).all()
    ref = pool.refcounts()
    assert ref[0] == 1 and set(ref[1:]) <= {0, 1}
    assert pool.page_fragmentation() > 0
    before = {s: [int(p) for p in pool.tables[s][:int(pool._n_pages[s])]]
              for s in (a, c)}
    cache = pool.defrag_pages(cache)
    assert pool.page_fragmentation() == 0.0
    assert sorted(np.flatnonzero(pool.refcounts()[1:]) + 1) == [1, 2, 3]
    for s in (a, c):
        pages = pool.tables[s][:len(before[s])]
        assert (cache["layers"]["k"][:, pages] == float(s + 1)).all()
    pool.free(a)
    pool.free(c)
    assert pool.live_page_count() == 0 and pool.free_page_count == \
        pool.num_pages - 1


def test_page_pool_exhaustion_raises():
    pool = PagedCachePool(TCFG, 2, 10, page_size=5, num_pages=3,
                          device="cpu")
    a = pool.allocate("a")
    pool.reserve(a, 10)
    b = pool.allocate("b")
    with pytest.raises(PageError):
        pool.reserve(b, 1)


def test_engine_defrags_slots_and_pages_without_changing_tokens():
    eng, got, _ = _port("paged", 2, defrag_threshold=0.01)
    assert eng.stats.defrags > 0 and eng.stats.page_defrags > 0
    assert got == _port("slot", 2)[1]


# ------------------------------- the options the rest of serving brings --
def test_unported_options_raise():
    """The options that once raised here (sampling, fan-out, the prefix
    cache, the double-buffered loop, the recurrent and MoE families) are
    served; what still raises is what the JAX engine refuses too."""
    params = _weights()[1]
    eng = Engine(params, TCFG, num_slots=2, max_len=16, device="cpu",
                 page_size=5, prefix_cache=True, overlap=True)
    out = eng.run([Request(id="s", prompt=[1], max_new_tokens=3,
                           sampling=SamplingParams(temperature=0.8, seed=1)),
                   Request(id="n", prompt=[2, 3], max_new_tokens=3, n=2),
                   Request(id="g", prompt=[1], max_new_tokens=2,
                           sampling=SamplingParams())])
    assert sorted((r.id, r.stream, len(r.tokens)) for r in out) == [
        ("g", 0, 2), ("n", 0, 3), ("n", 1, 3), ("s", 0, 3)]
    assert eng.stats.fanout_groups == 1
    for arch in ("mamba2-780m", "granite-moe-1b-a400m"):
        cfg = smoke_config(t_get_arch(arch))
        p = init_params(cfg, torch.Generator().manual_seed(0),
                        dtype=torch.bfloat16, device="cpu")
        e = Engine(p, cfg, num_slots=2, max_len=16, device="cpu")
        assert len(e.run([Request(id="x", prompt=[1],
                                  max_new_tokens=2)])[0].tokens) == 2
    with pytest.raises(ValueError, match="n must be"):
        eng.submit(Request(id="z", prompt=[1], n=0))
    with pytest.raises(ValueError, match="exceeds num_slots"):
        eng.submit(Request(id="w", prompt=[1], n=3))
    with pytest.raises(ValueError, match="kv_dtype requires a paged pool"):
        Engine(params, TCFG, num_slots=2, max_len=16, kv_dtype="int8",
               device="cpu")
    whisper = smoke_config(t_get_arch("whisper-medium"))
    wp = init_params(whisper, torch.Generator().manual_seed(0),
                     dtype=torch.bfloat16, device="cpu")
    with pytest.raises(ValueError, match="enc_embeds"):
        Engine(wp, whisper, num_slots=2, max_len=16,
               device="cpu").submit(Request(id="a", prompt=[1]))


def test_engine_and_cli_default_to_the_card():
    """The engine, its pools and the CLI run on the card unless asked for
    the CPU, and raise on a host without one."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(_weights()[1], TCFG, num_slots=2, max_len=16)
    for pool, kw in ((CachePool, {}), (PagedCachePool, dict(page_size=5))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pool(TCFG, 2, 16, **kw)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_cli.main(["--preset", "tiny"])


# --------------------------------------------------------------------- CLI --
@pytest.mark.parametrize("argv", [
    ["--page-size", "5"], ["--page-size", "5", "--kv-dtype", "int8"],
    [], ["--engine", "off"],
    ["--temperature", "0.8", "--top-p", "0.9", "--top-k", "20",
     "--sample-seed", "3"],
    ["--page-size", "4", "--prefix-cache", "--overlap"],
    ["--page-size", "4", "--temperature", "0.7", "--n", "2"]],
    ids=["paged", "int8", "slot", "classic", "sampled", "prefix-overlap",
         "fanout"])
def test_serve_cli_on_cpu(capsys, argv):
    out = serve_cli.main(["--device", "cpu", "--preset", "tiny",
                          "--batch", "2", "--new-tokens", "4",
                          "--requests", "3"] + argv)
    text = capsys.readouterr().out
    if argv == ["--engine", "off"]:
        assert tuple(out.shape) == (2, 4)
        return
    n = 2 if "--n" in argv else 1
    assert "steady-state" in text and f"retired={3 * n}" in text
    assert len(out) == 3 * n and all(len(r.tokens) == 4 for r in out)


@pytest.mark.parametrize("arch", ["mamba2-780m", "whisper-medium"])
def test_serve_cli_streams_every_family(capsys, arch):
    """``--stream`` with sampling prints each request's deltas; the engine
    serves the ssm family (slot pool) and whisper (cross K/V prefilled at
    admission from seeded frames)."""
    eng = serve_cli.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                          "--new-tokens", "3", "--requests", "3",
                          "--max-len", "16", "--stream", "--temperature",
                          "0.8", "--page-size", "4"])
    text = capsys.readouterr().out
    assert "stream=on" in text and "finish=length total=3" in text
    assert eng.stats.retired == 3 and eng.stats.steps == eng.stats.syncs * 4

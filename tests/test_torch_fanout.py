"""n>1 fan-out over shared prompt pages: the port against the JAX engine
(``tests/test_fanout.py``'s cases).

Stream i of an n-stream request is a standalone request seeded
``fold_in_seed(seed, i)``: its tokens equal that request's bit for bit at
every k, blocking and double-buffered, through a defrag; the port's engine
running the JAX package's model gives the JAX engine's fan-out streams;
the streams share the prompt's whole pages and return them at retirement.
"""
import contextlib
import functools

import pytest

from repro.kernels import registry as jregistry
from repro.serve import (Engine as JEngine, Request as JRequest,
                         SamplingParams as JSampling)
from repro_torch.serve import (Engine, Request, SamplingParams, Scheduler,
                               fold_in_seed)

from _torch_port import family_setup, jax_model_in_port_engine

NAME = "internlm2-1.8b"
PROMPT = [7, 3, 11, 5, 2, 9, 6, 1]
N_NEW = 6
BASE_SEED = 123
SP = dict(temperature=0.8, top_p=0.9, top_k=8)


@functools.lru_cache(maxsize=None)
def _standalone(stream: int):
    """Tokens of the lone-request reference for fan-out stream ``stream``."""
    _, tcfg, _, tp = family_setup(NAME)
    eng = Engine(tp, tcfg, num_slots=1, max_len=32, k=4, max_prompt=8,
                 page_size=5, device="cpu")
    return eng.run([Request(
        id=f"ref{stream}", prompt=PROMPT, max_new_tokens=N_NEW,
        sampling=SamplingParams(seed=fold_in_seed(BASE_SEED, stream),
                                **SP))])[0].tokens


def _fanout(*, k, overlap=False, num_slots=4, fillers=(), page_size=5,
            jax_model=False):
    cfg, tcfg, jp, tp = family_setup(NAME)
    reqs = [Request(id=f"f{i}", prompt=[9 + i], max_new_tokens=mn,
                    sampling=SamplingParams(temperature=1.2, seed=100 + i))
            for i, mn in enumerate(fillers)]
    reqs.append(Request(id="g", prompt=PROMPT, max_new_tokens=N_NEW,
                        sampling=SamplingParams(seed=BASE_SEED, **SP), n=4))
    with (jax_model_in_port_engine(cfg, jp) if jax_model
          else contextlib.nullcontext()):
        eng = Engine(tp, tcfg, num_slots=num_slots, max_len=32, k=k,
                     max_prompt=8, page_size=page_size, overlap=overlap,
                     device="cpu")
        out = eng.run(reqs)
    return {r.stream: r.tokens for r in out if r.id == "g"}, eng


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("k", [1, 4, 16])
def test_fanout_streams_bit_identical_to_standalone(k, overlap):
    got, eng = _fanout(k=k, overlap=overlap)
    assert sorted(got) == [0, 1, 2, 3]
    for i in range(4):
        assert got[i] == _standalone(i), f"stream {i} diverged"
    assert len({tuple(t) for t in got.values()}) > 1
    assert eng.stats.fanout_groups == 1 and eng.stats.fanout_streams == 4


@pytest.mark.parametrize("k", [1, 4])
def test_fanout_matches_the_jax_engine(k):
    """The port's engine running JAX's model: the JAX engine's four
    streams, and its page sharing, bit for bit."""
    cfg, _, jp, _ = family_setup(NAME)
    with jregistry.use("xla"):
        jeng = JEngine(jp, cfg, num_slots=4, max_len=32, k=k, max_prompt=8,
                       page_size=5)
        want = {r.stream: r.tokens for r in jeng.run([JRequest(
            id="g", prompt=PROMPT, max_new_tokens=N_NEW,
            sampling=JSampling(seed=BASE_SEED, **SP), n=4)])}
    got, eng = _fanout(k=k, jax_model=True)
    assert got == want
    assert eng.stats.shared_prompt_pages == jeng.stats.shared_prompt_pages


def test_fanout_survives_defrag_mid_stream():
    got, eng = _fanout(k=4, num_slots=8, fillers=(2, 2, 2, 2))
    assert eng.stats.defrags + eng.stats.page_defrags >= 1
    for i in range(4):
        assert got[i] == _standalone(i), f"stream {i} diverged"


def test_fanout_greedy_streams_coincide():
    _, tcfg, _, tp = family_setup(NAME)
    eng = Engine(tp, tcfg, num_slots=3, max_len=32, k=4, max_prompt=8,
                 page_size=5, device="cpu")
    out = eng.run([Request(id="g", prompt=PROMPT, max_new_tokens=4, n=3)])
    assert sorted(r.stream for r in out) == [0, 1, 2]
    assert len({tuple(r.tokens) for r in out}) == 1


def test_fanout_shares_prompt_pages_and_releases_them():
    got, eng = _fanout(k=4)
    assert eng.stats.shared_prompt_pages == 3
    assert eng.pool.live_page_count() == 0
    assert eng.pool.free_page_count == eng.pool.num_pages - 1
    assert eng._groups == {}


def test_fanout_deltas_carry_stream_index():
    _, tcfg, _, tp = family_setup(NAME)
    eng = Engine(tp, tcfg, num_slots=2, max_len=32, k=4, max_prompt=8,
                 page_size=5, device="cpu")
    got: dict = {}
    for d in eng.stream([Request(
            id="g", prompt=PROMPT, max_new_tokens=N_NEW,
            sampling=SamplingParams(seed=BASE_SEED, **SP), n=2)]):
        got.setdefault(d.stream, []).extend(d.tokens)
        if d.done:
            assert d.response.stream == d.stream
    assert sorted(got) == [0, 1]
    for i in (0, 1):
        assert got[i] == _standalone(i)


def test_group_admission_is_atomic():
    sch = Scheduler(clock=lambda: 0.0)
    sch.submit(Request(id="wide", prompt=[1], n=3))
    sch.submit(Request(id="narrow", prompt=[2]))
    admit, shed = sch.schedule(free_slots=2)
    assert admit == [] and shed == []
    assert len(sch) == 2
    admit, _ = sch.schedule(free_slots=4)
    assert [r.id for r in admit] == ["wide", "narrow"]


def test_submit_validates_n():
    _, tcfg, _, tp = family_setup(NAME)
    eng = Engine(tp, tcfg, num_slots=2, max_len=16, k=2, max_prompt=4,
                 page_size=4, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(Request(id="zero", prompt=[1], n=0))
    with pytest.raises(ValueError):
        eng.submit(Request(id="wide", prompt=[1], n=3))

"""The double-buffered engine (``overlap=True``) against the blocking one
and against the JAX engine (``tests/test_overlap.py``'s cases).

Every family, k in {1, 4, 16}, greedy and sampled: the overlapped engine's
streams equal the blocking engine's bit for bit (its own model) and the
JAX overlapped engine's (the port's engine running JAX's model); the
fetches made while a newer block is in flight are counted as hidden, by
the engine and by the port's sync audit alike (the JAX suite's audit case
fails in the JAX package itself, ``jax.core.trace_state_clean``, so it is
held to ``EngineStats`` and the port's audit here); a retired slot stays
fenced until its block lands; defrag flushes the pipeline; deadlines are
measured at launch.
"""
import functools

import pytest

from repro_torch import obs
from repro_torch.dist import DeadlineGate
from repro_torch.serve import Engine, FINISH_SHED, Request, Scheduler

from _torch_port import (FAMILY_ARCHS, family_setup, jax_engine_streams,
                         port_engine_streams)

MAX_LEN = 32


def _drain(name, *, k, sampled, overlap, **kw):
    return port_engine_streams(name, sampled, k=k, overlap=overlap,
                               audit=True, **kw)


@functools.lru_cache(maxsize=None)
def _blocking(name, sampled):
    return _drain(name, k=4, sampled=sampled, overlap=False)[0]


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_overlap_engine_matches_blocking_engine(name, mode, k):
    """Bit-identical to the blocking engine; hidden syncs whenever more
    than one block ran, the same count in the port's audit; one audited
    round trip a block; the pipeline drained clean."""
    sampled = mode == "sampled"
    got, eng, audit = _drain(name, k=k, sampled=sampled, overlap=True)
    assert got == _blocking(name, sampled)
    s = eng.stats
    assert s.steps == s.syncs * k
    if s.syncs > 1:
        assert s.hidden_syncs > 0
    assert s.blocking_syncs >= 1
    assert audit.syncs == s.syncs == audit.dispatches
    assert audit.overlap_epochs == s.hidden_syncs
    assert not eng._pipe


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_overlap_engine_matches_the_jax_engine(name, mode):
    """The port's overlapped engine running JAX's model gives the JAX
    overlapped engine's streams bit for bit."""
    sampled = mode == "sampled"
    got, _, _ = _drain(name, k=4, sampled=sampled, overlap=True,
                       jax_model=True)
    assert got == jax_engine_streams(name, sampled, overlap=True)


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_hidden_syncs_audited(mode):
    """The JAX suite's audit case, held to the port's audit: one audited
    epoch a sync, exactly the fetches made with a newer block in flight
    hidden, all inside the decode span; none hidden without overlap."""
    obs.enable()
    try:
        _, eng, audit = _drain("internlm2-1.8b", k=4,
                               sampled=mode == "sampled", overlap=True)
        s = eng.stats
        assert audit.syncs == s.syncs == audit.dispatches
        assert audit.overlap_epochs == s.hidden_syncs > 0
        assert audit.blocking_syncs == s.blocking_syncs
        assert audit.by_span == {"serve.decode_block": audit.syncs}
        hidden = obs.REGISTRY.get("repro_serve_hidden_syncs_total")
        assert hidden.total() == s.hidden_syncs
        _, eng, audit = _drain("internlm2-1.8b", k=4,
                               sampled=mode == "sampled", overlap=False)
        assert audit.syncs == eng.stats.syncs
        assert audit.overlap_epochs == 0 and eng.stats.hidden_syncs == 0
    finally:
        obs.disable()
        obs.reset()


def test_overlap_paged_prefix_parity():
    kw = dict(k=4, sampled=False, page_size=5, prefix_cache=True)
    want, _, _ = _drain("internlm2-1.8b", overlap=False, **kw)
    got, eng, _ = _drain("internlm2-1.8b", overlap=True, **kw)
    assert got == want
    assert eng.paged and eng.pool.live_page_count() == len(
        {n.page for n in eng.pool.prefix.iter_nodes()})


def _tiny():
    _, tcfg, _, tp = family_setup("internlm2-1.8b")
    return tcfg, tp


def test_fenced_slot_not_reused_until_block_lands():
    tcfg, tp = _tiny()
    reqs = [Request(id=f"f{i}", prompt=[3 + i], max_new_tokens=1 + 3 * i)
            for i in range(6)]
    eng = Engine(tp, tcfg, num_slots=2, max_len=MAX_LEN, k=2, max_prompt=8,
                 overlap=True, device="cpu")
    for r in reqs:
        eng.submit(r)
    out = []
    for _ in range(200):
        if eng._drained():
            break
        for inf in eng._pipe:
            for slot in inf.slots:
                assert eng.pool.owner(slot) is not None, \
                    f"slot {slot} freed under an in-flight block"
        out.extend(eng.step())
    assert eng._drained()
    got = {r.id: list(r.tokens) for r in out}
    for r in reqs:
        assert len(got[r.id]) == r.max_new_tokens
    eng2 = Engine(tp, tcfg, num_slots=2, max_len=MAX_LEN, k=2, max_prompt=8,
                  device="cpu")
    want = {r.id: list(r.tokens) for r in eng2.run(
        [Request(id=q.id, prompt=list(q.prompt),
                 max_new_tokens=q.max_new_tokens) for q in reqs])}
    assert got == want


def test_overlap_defrag_flushes_pipeline():
    tcfg, tp = _tiny()
    reqs = [(f"d{i}", [5, i + 1], 2 + 4 * i) for i in range(4)]
    runs = {}
    for overlap in (False, True):
        eng = Engine(tp, tcfg, num_slots=4, max_len=MAX_LEN, k=2,
                     max_prompt=8, overlap=overlap, defrag_threshold=0.25,
                     device="cpu")
        out = eng.run([Request(id=i, prompt=p, max_new_tokens=n)
                       for i, p, n in reqs])
        runs[overlap] = {r.id: list(r.tokens) for r in out}
        if overlap:
            assert eng.stats.defrags > 0
    assert runs[True] == runs[False]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _deadline_run(overlap, deadline):
    tcfg, tp = _tiny()
    gate = None if deadline is None else \
        DeadlineGate(deadline_s=deadline, quorum=0.5)
    eng = Engine(tp, tcfg, num_slots=1, max_len=MAX_LEN, k=2, max_prompt=8,
                 overlap=overlap, device="cpu",
                 scheduler=Scheduler(gate=gate, clock=_Clock()))
    out = eng.run([Request(id=f"q{i}", prompt=[7 + i], max_new_tokens=2)
                   for i in range(3)])
    return {r.id: r for r in out}


def test_deadline_measured_at_dispatch_time():
    ungated = _deadline_run(True, None)
    worst = max(r.queue_wait_s for r in ungated.values())
    got = _deadline_run(True, worst + 0.5)
    assert all(r.finish_reason != FINISH_SHED for r in got.values())
    for rid, r in got.items():
        assert r.queue_wait_s == ungated[rid].queue_wait_s
    shed = _deadline_run(True, 0.5)
    assert any(r.finish_reason == FINISH_SHED for r in shed.values())

"""The port's observability (``repro_torch.obs``) against the JAX package's
(``repro.obs``), and its threading through the port.

- Spans and metrics: the same calls give the same Prometheus text, JSONL
  and snapshot, and Chrome traces equal apart from the clock fields.
- ``SyncAudit``: a seeded sequence of reads, dispatches, fetches with fresh
  and stale tickets and spans, fed to both classes, gives the same
  ``as_dict()``; the torch patches exist only inside an audit, count only
  reads of the audited device, and never host data.
- The host-loop Lasso solves of all four rules make exactly T/k round-trip
  epochs under CA and T classical, equal to ``HostSyncs.blocks``, with the
  same bits as the solve without the host loop and within
  ``tests/test_torch_solvers.py``'s tolerances of the JAX solve.
- The engine: the audited round trips equal ``EngineStats.syncs`` bitwise
  at k in {1, 4, 16} for internlm2's smoke config and for the other
  families (mamba2's slot pool among them), all inside the
  ``serve.decode_block`` span; its metrics mirror its stats, the prefix,
  copy-on-write and hidden-sync counters too; streams are the same with
  obs on and off.
- The registry's dispatch counter, the training runner's counters and
  spans after an injected failure, and both CLIs' ``--metrics`` and
  ``--trace-out``.

Everything runs on the CPU, where the audit is given ``device="cpu"``;
the card's cases are in ``tests/test_torch_cuda.py``.
"""
import contextlib
import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro import obs as jobs
from repro.core import sstep as jsstep
from repro.kernels import registry as jregistry
from repro.obs.sync_audit import SyncAudit as JSyncAudit
from repro_torch import obs
from repro_torch.configs import get_arch, smoke_config
from repro_torch.core import sstep
from repro_torch.data import TokenStream
from repro_torch.dist import FailureSource, TrainingRunner
from repro_torch.kernels import registry
from repro_torch.launch import serve as serve_cli, train as train_cli
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models import init_params
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs.sync_audit import SyncAudit, block_until_ready
from repro_torch.serve import Engine, Request

from _torch_port import SOLVER_ATOL, jax_draws, to_torch_config, \
    to_torch_problem

KEY = jax.random.PRNGKey(42)
#: the JAX package's tolerances of a port solve against its own
#: (tests/test_torch_solvers.py): BCD's in-block replay reassociates a
#: matrix-vector product
RULE_ATOL = {"fista": SOLVER_ATOL, "pnm": SOLVER_ATOL, "pdhg": SOLVER_ATOL,
             "bcd": 2e-5}
#: a well-formed Prometheus sample line
SAMPLE = re.compile(r'^[A-Za-z_:][A-Za-z0-9_:]*(\{[^{}]*\})? -?[0-9.eE+-]+$')
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _obs_clean():
    """Every test starts and ends with both packages' obs disabled and
    empty."""
    for o in (obs, jobs):
        o.disable()
        o.reset()
    yield
    for o in (obs, jobs):
        o.disable()
        o.reset()


def _prometheus_parses(text):
    lines = [l for l in text.strip().splitlines() if not l.startswith("#")]
    assert lines and all(SAMPLE.match(l) for l in lines), text


# ---------------------------------------------------------------------------
# spans and metrics: parity with repro.obs
# ---------------------------------------------------------------------------

def _drive_spans(o):
    with o.span("outer", phase="test"):
        assert o.current() == "outer"
        with o.span("inner"):
            assert o.current() == "inner"
            o.instant("marker", n=3)
        o.instant("edge")
    with o.span("second", k=4, live=2):
        pass
    assert o.current() == ""


def _no_clock(trace):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in trace["traceEvents"]]


def test_spans_export_the_same_trace_as_jax(tmp_path):
    jobs.enable()
    obs.enable()
    _drive_spans(jobs)
    _drive_spans(obs)
    want, got = jobs.to_chrome_trace(), obs.to_chrome_trace()
    assert _no_clock(got) == _no_clock(want)
    assert [e["name"] for e in got["traceEvents"]] == \
        ["marker", "inner", "edge", "outer", "second"]
    assert {k: v for k, v in got.items() if k != "traceEvents"} == \
        {k: v for k, v in want.items() if k != "traceEvents"}
    by_name = {e["name"]: e for e in got["traceEvents"]}
    outer, inner = by_name["outer"], by_name["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    path = tmp_path / "trace.json"
    obs.write_trace(str(path))
    assert json.loads(path.read_text())["traceEvents"] == got["traceEvents"]


def test_span_buffer_cap_counts_dropped_events(monkeypatch):
    monkeypatch.setattr(obs.spans, "MAX_EVENTS", 3)
    obs.enable()
    for i in range(5):
        obs.instant("tick", i=i)
    trace = obs.to_chrome_trace()
    assert len(trace["traceEvents"]) == 3
    assert trace["otherData"]["dropped"] == 2


def test_disabled_spans_are_the_shared_noop_and_record_nothing():
    assert not obs.enabled()
    s1, s2 = obs.span("a"), obs.span("b", x=1)
    assert s1 is s2 is obs.NOOP
    with s1:
        assert obs.current() == ""
    obs.instant("never")
    assert obs.to_chrome_trace()["traceEvents"] == []


def _drive_metrics(m, seed=0):
    """The same seeded calls on a fresh registry of metrics module ``m``;
    returns its three exports."""
    rng = np.random.default_rng(seed)
    reg = m.Registry()
    c = reg.counter("t_requests_total", "help text")
    g = reg.gauge("t_depth")
    h = reg.histogram("t_latency_seconds", "lat", buckets=(0.1, 1.0))
    d = reg.histogram("t_default_seconds")
    for _ in range(50):
        c.inc(float(rng.integers(1, 4)),
              reason=str(rng.choice(["eos", "len"])))
        g.set(float(rng.integers(0, 9)), kind="q")
        h.observe(float(rng.exponential(0.5)),
                  op=str(rng.choice(["x", "y"])))
        d.observe(float(rng.exponential(0.01)))
    c.inc()
    reg.counter("t_never_total")                 # no samples: not exported
    return reg.to_prometheus(), reg.to_jsonl(), reg.snapshot()


def test_metrics_export_the_same_text_jsonl_and_snapshot_as_jax():
    jobs.enable()
    obs.enable()
    got = _drive_metrics(tmetrics)
    want = _drive_metrics(jobs.metrics)
    assert got == want
    text, jsonl, snap = got
    _prometheus_parses(text)
    assert "t_never_total" not in text
    assert '# TYPE t_latency_seconds histogram' in text
    assert all(json.loads(l)["name"].startswith("t_")
               for l in jsonl.splitlines())
    assert snap["t_requests_total"] == 1.0


def test_metric_mutations_are_noops_while_disabled():
    reg = tmetrics.Registry()
    c, h = reg.counter("t_c"), reg.histogram("t_h")
    c.inc(reason="eos")
    h.observe(0.5)
    assert c.total() == 0.0 and h.count() == 0 and reg.to_prometheus() == ""
    with pytest.raises(TypeError, match="already registered as counter"):
        reg.histogram("t_c")


# ---------------------------------------------------------------------------
# SyncAudit: counting semantics against the JAX class
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sync_audit_counts_like_the_jax_class(seed):
    """Reads of each kind, dispatches, fetches of fresh, stale and no
    tickets, and nested spans (``by_span`` reads each package's current
    span), in one seeded order, through both classes' event methods."""
    rng = np.random.default_rng(seed)
    jobs.enable()
    obs.enable()
    ja, ta = JSyncAudit(), SyncAudit()
    seq, stack = 0, []
    for op in rng.integers(0, 7, 600):
        if op < 3:
            kind = ("block_until_ready", "device_get", "convert")[op]
            ja._read(kind)
            ta._read(kind)
        elif op == 3:
            seq += 1
            ja._dispatch(seq)
            ta._dispatch(seq)
        elif op == 4:
            ticket = [None, seq, seq - int(rng.integers(1, 3))][
                int(rng.integers(0, 3))]
            ja._fetch(ticket)
            ta._fetch(ticket)
        elif op == 5 and len(stack) < 3:
            name = f"s{int(rng.integers(0, 3))}"
            cms = contextlib.ExitStack()
            cms.enter_context(jobs.span(name))
            cms.enter_context(obs.span(name))
            stack.append(cms)
        elif op == 6 and stack:
            stack.pop().close()
        assert ta.as_dict() == ja.as_dict()
        assert ta.blocking_syncs == ja.blocking_syncs
    while stack:
        stack.pop().close()
    d = ta.as_dict()
    assert d["syncs"] > 0 and d["overlap_epochs"] > 0 and len(d["by_span"]) > 1


def _patched():
    return {"cpu": "cpu" in torch.Tensor.__dict__,
            "item": "item" in torch.Tensor.__dict__,
            "np.asarray": hasattr(np.asarray, "__wrapped__"),
            "cuda.synchronize": hasattr(torch.cuda.synchronize,
                                        "__wrapped__"),
            "Event.synchronize": hasattr(torch.cuda.Event.synchronize,
                                         "__wrapped__")}


def test_patches_exist_only_inside_an_audit():
    assert not any(_patched().values())
    with obs.sync_audit(CPU) as outer:
        assert all(_patched().values())
        with obs.sync_audit(CPU) as inner:
            float(torch.ones(1))
        assert all(_patched().values())      # the outer audit still runs
        float(torch.ones(1))
    assert not any(_patched().values())
    assert (outer.transfers, inner.transfers) == (2, 1)
    float(torch.ones(1))
    assert outer.transfers == 2
    # the inherited tensor methods are back as they were
    assert torch.Tensor.cpu is torch._C.TensorBase.cpu


def test_epochs_coalesce_between_dispatches():
    x = torch.arange(8, dtype=torch.float32)
    with obs.sync_audit(CPU) as a:
        obs.mark_dispatch("t")
        y = x * 2
        np.asarray(y)                     # opens epoch 1
        y.tolist()                        # coalesces: same epoch
        obs.mark_dispatch("t")
        y2 = x * 3
        block_until_ready(CPU)      # opens epoch 2
        float(y2[0])
        bool(y2[1] > 0)
        int(y2[2])
        y2[3].item()
    assert (a.syncs, a.dispatches, a.transfers) == (2, 2, 7)
    assert a.block_until_ready == 1 and a.device_get == 0


def test_host_data_and_other_devices_are_never_counted():
    x = torch.arange(6, dtype=torch.float32)
    with obs.sync_audit(CPU) as a:
        np.asarray([1, 2, 3])
        np.array(np.ones(4))
    with obs.sync_audit("cuda") as c:     # CPU tensors are host data here
        float(x[0])
        x.cpu().numpy()
        np.asarray(x)
        x.to("cpu", copy=True)
    assert a.transfers == 0 and c.as_dict() == SyncAudit().as_dict()


def test_fetches_count_copies_and_their_copies_are_host_data():
    """On the CPU ``.cpu()`` copies nothing (the read comes when the values
    are used); ``.to("cpu", copy=True)`` is a fetch, and its copy and that
    copy's views are host data afterwards."""
    x = torch.arange(6, dtype=torch.float32)
    with obs.sync_audit(CPU) as a:
        x.cpu()
        x.to("cpu")
        x.to(torch.float32)
        assert a.transfers == 0
        x.cpu().numpy()
        assert a.transfers == 1
        h = x.to("cpu", copy=True)
        assert (a.transfers, a.device_get) == (2, 1)
        h.numpy()
        h.reshape(2, 3).view(torch.int32).numpy()
        float(h[0])
        np.asarray(h)
        assert a.transfers == 2
    assert a.syncs == 1


def test_mark_dispatch_tickets_are_monotonic_and_fetches_classify():
    t0 = obs.mark_dispatch()                 # no audit: still a ticket
    x = torch.ones(2)
    with obs.sync_audit(CPU) as a:
        t1 = obs.mark_dispatch("a")
        t2 = obs.mark_dispatch("b")
        obs.mark_fetch(t1)                   # newer work in flight: hidden
        x.tolist()
        obs.mark_fetch(t2)                   # the latest: a stall
        x.tolist()
        obs.mark_fetch(None)
        x.tolist()
    assert t0 < t1 < t2
    assert (a.syncs, a.overlap_epochs, a.blocking_syncs) == (3, 1, 2)


# ---------------------------------------------------------------------------
# Lasso: host-loop round trips, all four rules
# ---------------------------------------------------------------------------

def _lasso():
    """tests/test_sstep.py's Lasso problem, in both packages."""
    kX, kw, kn = jax.random.split(KEY, 3)
    X = jax.random.normal(kX, (16, 256))
    w_true = jax.random.normal(kw, (16,))
    y = X.T @ w_true + 0.1 * jax.random.normal(kn, (256,))
    jprob = jcore.LassoProblem(X, y, lam=0.05)
    return jprob, to_torch_problem(jprob)


LASSO = _lasso()


@pytest.mark.parametrize("ca", [True, False], ids=["ca", "classical"])
@pytest.mark.parametrize("rule", ["fista", "pnm", "pdhg", "bcd"])
def test_host_loop_epochs_T_over_k_vs_T(rule, ca):
    """The paper's latency claim at the torch boundary: T/k round-trip
    epochs under CA, T classical, each equal to ``HostSyncs.blocks`` and to
    the marked dispatches; the host loop keeps the bits of the solve
    without it, and both stay within the parity tolerance of the JAX
    solve (the same draws and step)."""
    jprob, tprob = LASSO
    base = jcore.SolverConfig(T=32, k=8, b=0.25)
    cfg = dataclasses.replace(base, step_size=float(jprob.default_step(base)))
    tcfg = to_torch_config(cfg)
    jrule, trule = jsstep.RULES[rule], sstep.RULES[rule]
    idx = jax_draws(KEY, cfg, jprob, trule.schedule)
    blocks = sstep.HostSyncs()
    with obs.sync_audit(CPU) as audit:
        w = sstep.solve(tprob, tcfg, None, trule, name=rule, ca=ca, idx=idx,
                        host_loop=True, syncs=blocks)
    want = cfg.T // cfg.k if ca else cfg.T
    assert audit.syncs == audit.dispatches == blocks.blocks == want, \
        audit.as_dict()
    assert audit.transfers == audit.block_until_ready == want
    assert audit.by_span == {"": want}
    w_plain = sstep.solve(tprob, tcfg, None, trule, name=rule, ca=ca, idx=idx)
    assert torch.equal(w, w_plain)
    with jregistry.use("xla"):
        w_jax = jsstep.solve(jprob, cfg, KEY, jrule, name=rule, ca=ca)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_jax),
                               atol=RULE_ATOL[rule], rtol=0)


def test_solve_without_host_loop_marks_and_reads_nothing():
    _, tprob = LASSO
    tcfg = sstep.SolverConfig(T=16, k=4, b=0.25, step_size=0.5)
    with obs.sync_audit(CPU) as audit:
        sstep.solve(tprob, tcfg, 3, sstep.FISTA_RULE, name="ca_fista",
                    ca=True)
    assert audit.as_dict() == SyncAudit().as_dict()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

CFG = smoke_config(get_arch("internlm2-1.8b"))


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16, device="cpu")


def _engine_requests(n):
    rng = np.random.RandomState(0)
    return [Request(id=f"r{i}",
                    prompt=rng.randint(0, CFG.vocab, size=3).tolist(),
                    max_new_tokens=8) for i in range(n)]


def _audited_drain(params, k, n=4, slots=4, **kw):
    eng = Engine(params, CFG, num_slots=slots, max_len=32, k=k, max_prompt=4,
                 device="cpu", **kw)
    with obs.sync_audit(CPU) as audit:
        out = eng.run(_engine_requests(n))
    return audit, eng.stats, {r.id: r.tokens for r in out}


@pytest.mark.parametrize("k", [1, 4, 16])
def test_engine_sync_audit_bitwise_equals_stats(params, k):
    """The audited round trips equal ``EngineStats.syncs`` exactly, one
    marked dispatch a round (the other families:
    :func:`test_engine_sync_audit_equals_stats_for_every_family`)."""
    audit, stats, _ = _audited_drain(params, k)
    assert audit.syncs == stats.syncs == audit.dispatches, audit.as_dict()
    assert audit.transfers == stats.syncs      # the one fetch a round
    assert stats.steps == stats.syncs * k


def test_engine_syncs_amortize_by_k(params):
    syncs = {k: _audited_drain(params, k)[0].syncs for k in (1, 4, 16)}
    for k in (4, 16):
        assert 0 <= syncs[k] * k - syncs[1] < k, (syncs, k)


@pytest.mark.parametrize("page_size", [None, 5], ids=["slot", "paged"])
def test_engine_audit_attributes_syncs_to_decode_span(params, page_size):
    off = _audited_drain(params, 4, n=5, slots=2, page_size=page_size)
    obs.enable()
    audit, stats, streams = _audited_drain(params, 4, n=5, slots=2,
                                           page_size=page_size)
    assert audit.syncs == stats.syncs
    assert audit.by_span == {"serve.decode_block": audit.syncs}
    assert streams == off[2]              # obs changes no token
    names = [e["name"] for e in obs.to_chrome_trace()["traceEvents"]]
    assert names.count("serve.decode_block") == 2 * stats.syncs
    assert names.count("serve.retire") == 5
    # the span of every round (each runs a block) and the instant of every
    # admission
    assert names.count("serve.admit") == stats.syncs + 5


def test_engine_metrics_mirror_stats(params):
    obs.enable()
    eng = Engine(params, CFG, num_slots=2, max_len=32, k=4, max_prompt=4,
                 device="cpu")
    eng.run(_engine_requests(3))
    s, r = eng.stats, obs.REGISTRY
    assert r.get("repro_serve_syncs_total").total() == s.syncs
    assert r.get("repro_serve_steps_total").total() == s.steps
    assert r.get("repro_serve_tokens_total").total() == s.tokens_out
    assert r.get("repro_serve_prefill_tokens_total").total() == \
        s.prefill_tokens
    assert r.get("repro_serve_requests_total").value(reason="length") == \
        s.retired
    assert r.get("repro_serve_ttft_seconds").count() == s.admitted
    assert r.get("repro_serve_queue_wait_seconds").count() == s.admitted
    assert r.get("repro_serve_latency_seconds").count() == s.retired
    assert r.get("repro_serve_tpot_seconds").count() == s.retired
    assert r.get("repro_serve_host_blocked_seconds").count() == s.syncs
    assert r.get("repro_sched_queue_depth") is not None
    # no prefix cache, no overlap here: their counters are defined and 0
    # (they move in test_prefix_cow_and_hidden_sync_counters_move)
    for name in ("repro_serve_prefix_hits_total",
                 "repro_serve_prefix_tokens_total",
                 "repro_serve_cow_copies_total",
                 "repro_serve_hidden_syncs_total"):
        assert r.get(name) is not None and r.get(name).total() == 0
    text = obs.to_prometheus()
    _prometheus_parses(text)
    assert f"repro_serve_syncs_total {s.syncs}" in text


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b",
                                  "granite-moe-1b-a400m", "whisper-medium"])
def test_engine_sync_audit_equals_stats_for_every_family(arch):
    cfg = smoke_config(get_arch(arch))
    p = init_params(cfg, torch.Generator().manual_seed(0),
                    dtype=torch.bfloat16, device="cpu")
    rng = np.random.RandomState(0)
    reqs = [Request(id=f"r{i}", prompt=[3 + i, 5], max_new_tokens=5,
                    enc_embeds=rng.randn(16, cfg.d_model).astype(np.float32)
                    if cfg.family == "audio" else None) for i in range(3)]
    eng = Engine(p, cfg, num_slots=2, max_len=16, k=4, max_prompt=4,
                 enc_len=16, page_size=4, device="cpu")
    with obs.sync_audit(CPU) as audit:
        eng.run(reqs)
    s = eng.stats
    assert audit.syncs == s.syncs == audit.dispatches == audit.transfers
    assert s.retired == 3 and s.steps == s.syncs * 4


def test_prefix_cow_and_hidden_sync_counters_move(params):
    obs.enable()
    shared = [5, 9, 2, 7, 1, 8]              # 1.5 pages of 4
    eng = Engine(params, CFG, num_slots=2, max_len=32, k=2, max_prompt=8,
                 page_size=4, prefix_cache=True, overlap=True, device="cpu")
    # a publishes two whole prompt pages; each b matches the first and 2
    # tokens of the second: a copy-on-write each
    eng.run([Request(id="a", prompt=shared + [3, 3], max_new_tokens=3)])
    eng.run([Request(id=f"b{i}", prompt=shared + [4 + i, 6],
                     max_new_tokens=3) for i in range(3)])
    s, r = eng.stats, obs.REGISTRY
    assert s.prefix_hits == 3 and s.cow_copies == 3 and s.hidden_syncs > 0
    assert r.get("repro_serve_prefix_hits_total").total() == s.prefix_hits
    assert r.get("repro_serve_prefix_tokens_total").total() == \
        s.prefix_tokens == 3 * 6
    assert r.get("repro_serve_cow_copies_total").total() == s.cow_copies
    assert r.get("repro_serve_hidden_syncs_total").total() == \
        s.hidden_syncs


def test_scheduler_gate_sheds_into_the_counter():
    from repro_torch.dist import DeadlineGate
    from repro_torch.serve import Scheduler
    obs.enable()
    clock = iter(range(0, 1000, 5)).__next__
    sched = Scheduler(gate=DeadlineGate(deadline_s=1.0, quorum=0.5),
                      clock=clock)
    for i in range(4):
        sched.submit(Request(id=f"q{i}", prompt=[1], max_new_tokens=1))
    admit, shed = sched.schedule(free_slots=0)
    assert shed and obs.REGISTRY.get(
        "repro_sched_gate_shed_total").total() == len(shed)
    assert obs.REGISTRY.get("repro_sched_queue_depth").value() == 4


# ---------------------------------------------------------------------------
# the registry, the runner, the CLIs
# ---------------------------------------------------------------------------

def test_registry_dispatch_counter_mirrors_dispatch_counts():
    _, tprob = LASSO
    tcfg = to_torch_config(jcore.SolverConfig(T=16, k=4, b=0.25,
                                              step_size=0.5))
    obs.enable()
    registry.reset_dispatch_counts()
    for rule in ("fista", "pnm", "bcd"):
        sstep.solve(tprob, tcfg, 3, sstep.RULES[rule], name=rule, ca=True)
    counts = registry.dispatch_counts()
    m = obs.REGISTRY.get("repro_kernel_dispatch_total")
    assert counts and m.total() == sum(counts.values())
    for (op, backend), n in counts.items():
        assert m.value(op=op, backend=backend) == n
    obs.disable()
    registry.dispatch("gram", torch.ones(1, 2, 3))
    assert m.total() == sum(counts.values())          # disabled: unmoved
    assert registry.dispatch_counts()[("gram", "torch")] == \
        counts.get(("gram", "torch"), 0) + 1


def _runner(tmp_path, fail_at=()):
    def init_state():
        return init_train_state(CFG, torch.Generator().manual_seed(0),
                                device="cpu")

    def data(start):
        return TokenStream(batch=4, seq=16, vocab=CFG.vocab, seed=0,
                           start_step=start, device="cpu")

    step = make_train_step(CFG, ca_k=2, peak_lr=1e-3, warmup=2,
                           total_steps=6, remat=True)
    return TrainingRunner(lambda rules: step, None, data, init_state,
                          tmp_path / "ck",
                          ckpt_every=2, failure_source=FailureSource(fail_at))


def test_runner_counters_spans_and_one_sync_a_step(tmp_path):
    """After a failure at step 3: one restart, the checkpoint saves of
    steps 0, 2, 4, the re-run 2 and the final one; a step histogram entry
    and a marked dispatch for each of the 7 steps run, and one round trip
    each (plus the first snapshot's, before any step)."""
    obs.enable()
    runner = _runner(tmp_path, fail_at=[3])
    with obs.sync_audit(CPU) as audit:
        runner.run(6)
    r = obs.REGISTRY
    assert runner.restarts == 1
    assert r.get("repro_train_restarts_total").total() == 1
    assert r.get("repro_train_ckpt_saves_total").total() == 4
    assert r.get("repro_train_step_seconds").count() == 7
    names = [e["name"] for e in obs.to_chrome_trace()["traceEvents"]]
    assert names.count("train.step") == 7
    assert names.count("train.ckpt_save") == 4
    assert names.count("train.restore") == names.count("train.restart") == 1
    assert audit.dispatches == 7 and audit.syncs == 8
    assert audit.by_span == {"train.ckpt_save": 1, "train.step": 7}


def test_serve_cli_metrics_and_trace_export(tmp_path, capsys):
    mfile, tfile = tmp_path / "metrics.prom", tmp_path / "trace.json"
    serve_cli.main(["--device", "cpu", "--preset", "tiny", "--batch", "2",
                    "--requests", "2", "--new-tokens", "8", "--k", "4",
                    "--page-size", "5", "--metrics", str(mfile),
                    "--trace-out", str(tfile)])
    stdout = capsys.readouterr().out
    stats_syncs = int(re.search(r"stats: syncs=(\d+)", stdout).group(1))
    text = mfile.read_text()
    _prometheus_parses(text)
    prom_syncs = int(re.search(r"^repro_serve_syncs_total (\d+)$", text,
                               re.M).group(1))
    assert prom_syncs == stats_syncs
    assert "# TYPE repro_serve_ttft_seconds histogram" in text
    assert 'repro_kernel_dispatch_total{backend="torch",' \
           'op="paged_attention"}' in text
    names = {e["name"] for e in json.loads(tfile.read_text())["traceEvents"]}
    assert {"serve.decode_block", "serve.admit", "serve.retire"} <= names
    assert not obs.enabled()


def test_train_cli_metrics_to_stdout_and_trace(tmp_path, capsys):
    tfile = tmp_path / "trace.json"
    runner = train_cli.main(["--device", "cpu", "--preset", "tiny",
                             "--steps", "4", "--ckpt-every", "2",
                             "--fail-at", "3", "--ckpt-dir",
                             str(tmp_path / "ck"), "--metrics",
                             "--trace-out", str(tfile)])
    stdout = capsys.readouterr().out
    assert runner.restarts == 1
    text = stdout.split("# --- metrics (prometheus text) ---\n")[1]
    text = text.split("# wrote trace")[0]
    _prometheus_parses(text)
    assert re.search(r"^repro_train_restarts_total 1$", text, re.M)
    assert "# TYPE repro_train_step_seconds histogram" in text
    names = {e["name"] for e in json.loads(tfile.read_text())["traceEvents"]}
    assert {"train.step", "train.ckpt_save", "train.restore",
            "train.restart"} <= names
    assert not obs.enabled()

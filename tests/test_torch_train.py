"""The port's training path against the JAX package's, at the smoke config
on the CPU: ``loss_fn`` and its grads from one set of weights, AdamW and
the cosine schedule, one and three CA (k=2) and classical train steps from
one state (internlm2, and mamba2 through ``SSDFn``), the token stream's
bits and its restart, a checkpoint round trip, the fault-tolerant runner
and the train CLI. JAX runs with its XLA
backend, as its own training tests do; inputs come from numpy or from the
JAX package's own draws, carried across."""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data import TokenStream as JTokenStream
from repro.data import make_token_batch as j_make_token_batch
from repro.kernels import registry as jregistry
from repro.launch.steps import init_train_state as j_init_train_state
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import cosine_schedule as j_cosine_schedule
from repro_torch import kernels
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import TokenStream, make_token_batch
from repro_torch.dist import FailureSource, NodeFailure, TrainingRunner
from repro_torch.kernels import registry
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import (TrainState, init_train_state,
                                      make_train_step)
from repro_torch.models import (loss_fn, params_from_numpy,
                                train_state_from_numpy)
from repro_torch.optim import (OptState, adamw_init, adamw_update,
                               cosine_schedule)
from repro_torch.tree import leaves

from _torch_port import to_torch_config_arch

CFG = jconfigs.smoke_config(jconfigs.get_arch("internlm2-1.8b"))
TCFG = to_torch_config_arch(CFG)
#: the JAX package's own grad tolerance for two bf16 computations of one
#: gradient (tests/test_train.py, CA vs full batch)
GRAD_TOL = dict(atol=5e-3, rtol=5e-2)
#: loss and grad norm: means over thousands of bf16 logits and grads that
#: the two frameworks round at other points; about one bf16 step (2^-8)
SCALAR_RTOL = 5e-3


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_leaves(jax_tree):
    """A JAX parameter-shaped tree (layers stacked) as the port's leaves,
    float32, in the port's order."""
    return leaves(params_from_numpy(TCFG, _np_tree(jax_tree),
                                    dtype=torch.float32))


def _jax_batch(seed, batch=8, seq=16):
    toks, labels = j_make_token_batch(jax.random.PRNGKey(seed), batch, seq,
                                      CFG.vocab)
    return dict(tokens=toks, labels=labels)


def _to_port(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _close(got, want, what, atol=0.0, rtol=0.0):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   w.detach().float().numpy(), atol=atol,
                                   rtol=rtol, err_msg=f"{what} leaf {i}")


# ------------------------------------------------------------- loss_fn ---
@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_and_grads_match_jax(remat):
    jp = j_init_params(CFG, jax.random.PRNGKey(0))
    batch = _jax_batch(1)
    with jregistry.use("xla"):
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: j_loss_fn(p, CFG, batch, remat=remat)))(jp)
    params = params_from_numpy(TCFG, _np_tree(jp), dtype=torch.float32)
    ps = [t.requires_grad_() for t in leaves(params)]
    loss = loss_fn(params, TCFG, _to_port(batch), remat=remat)
    grads = torch.autograd.grad(loss, ps)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=SCALAR_RTOL)
    assert all(g.dtype == torch.float32 for g in grads)
    _close(grads, _port_leaves(jg), "grad", **GRAD_TOL)


def test_remat_gives_the_same_bits_and_recomputes_the_forward():
    """Per-layer checkpointing changes no number: the recompute is the
    forward's arithmetic. It runs the attention forward twice a layer."""
    weights = _np_tree(j_init_params(CFG, jax.random.PRNGKey(0)))
    batch = _to_port(_jax_batch(2))
    out = {}
    for remat in (False, True):
        p = params_from_numpy(TCFG, weights, dtype=torch.float32)
        ps = [t.requires_grad_() for t in leaves(p)]
        registry.reset_dispatch_counts()
        loss = loss_fn(p, TCFG, batch, remat=remat)
        out[remat] = (loss, torch.autograd.grad(loss, ps),
                      registry.dispatch_counts())
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)
    n = CFG.n_layers
    assert out[False][2] == {("flash_attention", "torch"): n,
                             ("flash_dq", "torch"): n,
                             ("flash_dkv", "torch"): n}
    assert out[True][2][("flash_attention", "torch")] == 2 * n


# ------------------------------------------------------ AdamW, schedule ---
def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (scale * rng.standard_normal((7, 5))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal(11)).astype(np.float32),
                  "d": (scale * rng.standard_normal((3, 2, 4))).astype(
                      np.float32)}}


def test_adamw_update_matches_jax():
    """Three updates with clipping active (grad norm > 1) and not, the same
    numbers in, float32 arithmetic on both sides (rtol 1e-6, atol 1e-7:
    the order of the grad-norm sum and pow's last bit)."""
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), _tree(0))
    jst, tst = j_adamw_init(jp), adamw_init(tp)
    for i, gscale in enumerate((3.0, 0.05, 1.0)):
        g = _tree(10 + i, gscale)
        lr = 1e-2 * (i + 1)
        jp, jst, jgn = j_adamw_update(jp, jax.tree.map(jnp.asarray, g), jst,
                                      lr=lr)
        tp, tst, tgn = adamw_update(
            tp, jax.tree.map(lambda a: torch.from_numpy(a), g), tst,
            lr=torch.tensor(lr))
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
        for got, want in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v)):
            for gl, wl in zip(leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(gl.numpy(), np.asarray(wl),
                                           rtol=1e-6, atol=1e-7)
        assert int(tst.step) == int(jst.step) == i + 1
        assert tst.step.dtype == torch.int32


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (5, 5)])
def test_cosine_schedule_matches_jax(warmup, total):
    steps = np.arange(0, total + 20, 3, dtype=np.int32)
    want = np.asarray([j_cosine_schedule(jnp.int32(s), peak_lr=3e-4,
                                         warmup=warmup, total=total)
                       for s in steps])
    got = np.asarray([float(cosine_schedule(torch.tensor(s), peak_lr=3e-4,
                                            warmup=warmup, total=total))
                      for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------- train step ---
#: AdamW's first-moment decay (b1 = 0.9): one update moves m by (1 - b1) g
ADAM_B1 = 0.9
#: per-leaf normwise bound on the params' update against JAX's:
#: ||(p - p0) - (p_jax - p0)|| / ||p_jax - p0||. Adam's first step is
#: lr * sign(g) on every element, so a gradient at the bf16 noise floor
#: flips its sign; over the CA, classical, remat cases at steps 1 to 3 the
#: worst leaf reads 0.169 on the CPU. A leaf whose update is skipped reads
#: 1, and one whose update has the wrong sign reads 2.
UPDATE_RTOL = 0.3


def _update_rel(params, params0, jparams):
    """Per-leaf normwise distance of the port's update from JAX's."""
    out = []
    for p, p0, w in zip(leaves(params), params0, _port_leaves(jparams)):
        got, want = (p - p0).double(), (w - p0).double()
        out.append(float((got - want).norm() / want.norm().clamp_min(1e-30)))
    return np.array(out)


@pytest.mark.parametrize("remat", [False, True], ids=["noremat", "remat"])
@pytest.mark.parametrize("classical", [False, True], ids=["ca2", "classical"])
def test_train_steps_match_jax(classical, remat):
    """One and three steps of ``make_train_step`` (ca_k=2, CA or classical)
    against the JAX package's ``make_train_step(cfg, None, ...)`` from the
    same state (``train_state_from_numpy``) on the same batches, with no
    warmup so the first update moves the params. Loss, grad norm and lr per
    step; the first moment m at the grad tolerance scaled by (1 - b1) (a
    decayed mean of gradients); each leaf's update (params - params0)
    against JAX's, normwise within ``UPDATE_RTOL``."""
    kw = dict(ca_k=2, peak_lr=1e-3, warmup=0, total_steps=10)
    jstate = j_init_train_state(CFG, jax.random.PRNGKey(0))
    state = train_state_from_numpy(TCFG, _np_tree(jstate))
    assert state.params["embed"].dtype == torch.float32
    params0 = [t.clone() for t in leaves(state.params)]
    with jregistry.use("xla"):
        jstep = jax.jit(j_make_train_step(
            CFG, None, remat=False, sync_every_microbatch=classical, **kw))
    step = make_train_step(TCFG, remat=remat,
                           sync_every_microbatch=classical, **kw)
    m_tol = dict(atol=(1 - ADAM_B1) * GRAD_TOL["atol"],
                 rtol=GRAD_TOL["rtol"])
    for i in range(3):
        batch = _jax_batch(10 + i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, _to_port(batch))
        assert all(isinstance(v, torch.Tensor) for v in m.values())
        assert float(m["lr"]) > 0
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                       rtol=SCALAR_RTOL, err_msg=name)
        updates = 2 if classical else 1
        assert int(state.opt.step) == int(jstate.opt.step) == updates * (
            i + 1)
        if i in (0, 2):
            _close(leaves(state.opt.m), _port_leaves(jstate.opt.m), "m",
                   **m_tol)
            rel = _update_rel(state.params, params0, jstate.params)
            assert rel.max() <= UPDATE_RTOL, (
                f"step {i + 1}: leaf {rel.argmax()} update off JAX's by "
                f"{rel.max():.3f} normwise (limit {UPDATE_RTOL})")


def test_ca_accumulated_grad_matches_full_batch_and_classical_runs():
    """The JAX package's own checks (tests/test_train.py): the CA step's
    accumulated gradient equals the full-batch gradient (linearity), and
    both schedules run."""
    params = params_from_numpy(TCFG, _np_tree(j_init_params(
        CFG, jax.random.PRNGKey(0))), dtype=torch.float32)
    batch = _to_port(_jax_batch(1))
    ps = [t.requires_grad_() for t in leaves(params)]
    g_full = torch.autograd.grad(loss_fn(params, TCFG, batch), ps)
    acc = [torch.zeros_like(t) for t in ps]
    for i in range(4):
        mb = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
        for a, g in zip(acc, torch.autograd.grad(loss_fn(params, TCFG, mb),
                                                 ps)):
            a.add_(g / 4)
    _close(acc, g_full, "grad", **GRAD_TOL)
    for classical in (False, True):
        state = init_train_state(TCFG, torch.Generator().manual_seed(0),
                                 device="cpu")
        step = make_train_step(TCFG, ca_k=2, remat=False,
                               sync_every_microbatch=classical)
        _, m = step(state, batch)
        assert np.isfinite(float(m["loss"]))


def test_train_loss_decreases():
    """30 steps on one batch at lr 1e-2 bring the loss below 0.7 of the
    first (tests/test_train.py)."""
    state = init_train_state(TCFG, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(TCFG, ca_k=2, peak_lr=1e-2, warmup=2,
                           total_steps=60, remat=False)
    batch = _to_port(_jax_batch(1))
    losses = []
    for _ in range(30):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses[::6]


# ------------------------------------------------------------ the data ---
def test_token_stream_bits_equal_jax_and_restart():
    js = JTokenStream(batch=4, seq=8, vocab=100, seed=7)
    ts = TokenStream(batch=4, seq=8, vocab=100, seed=7, device="cpu")
    try:
        jb = [next(js) for _ in range(5)]
        tb = [next(ts) for _ in range(5)]
    finally:
        js.close()
        ts.close()
    for a, b in zip(jb, tb):
        for k in ("tokens", "labels"):
            assert b[k].dtype == torch.int32 and b[k].shape == (4, 8)
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))
    assert ts.state() == dict(step=5, seed=7)
    again = TokenStream(batch=4, seq=8, vocab=100, seed=7, start_step=3,
                        device="cpu")
    try:
        b3, b4 = next(again), next(again)
    finally:
        again.close()
    assert torch.equal(b3["tokens"], tb[3]["tokens"])
    assert torch.equal(b4["labels"], tb[4]["labels"])
    assert not again._thread.is_alive()


def test_make_token_batch_is_next_token_pairs():
    b = make_token_batch(3, 2, 6, 50, device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 50, (2, 7), dtype=np.int32)
    np.testing.assert_array_equal(b["tokens"].numpy(), toks[:, :-1])
    np.testing.assert_array_equal(b["labels"].numpy(), toks[:, 1:])


# ---------------------------------------------------------- checkpoint ---
def test_checkpoint_round_trip_with_bf16(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = TrainState(
        params={"w": torch.randn(3, 4, generator=gen),
                "h": torch.randn(5, generator=gen).to(torch.bfloat16),
                "layers": [{"g": torch.randn(2, 2, generator=gen)}]},
        opt=OptState(step=torch.tensor(7, dtype=torch.int32),
                     m={"x": torch.randn(2, generator=gen).to(
                         torch.bfloat16)},
                     v={"x": torch.zeros(2)}))
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3):
        ck.save(s, tree, extra={"s": s})
    ck.wait()
    assert sorted(ck.steps()) == [2, 3] and ck.latest_step() == 3
    assert not list(tmp_path.glob("*.tmp"))
    files = sorted(p.name for p in (tmp_path / "step_3").iterdir())
    assert files == ["arrays", "manifest.json"]
    template = TrainState(
        params={"w": torch.zeros(3, 4), "h": torch.zeros(
            5, dtype=torch.bfloat16), "layers": [{"g": torch.zeros(2, 2)}]},
        opt=OptState(step=torch.zeros((), dtype=torch.int32),
                     m={"x": torch.zeros(2, dtype=torch.bfloat16)},
                     v={"x": torch.ones(2)}))
    got, step, extra = ck.restore(template)
    assert step == 3 and extra == {"s": 3} and got is template
    for a, b in zip(leaves(list(got)), leaves(list(tree))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    bad = {"w": torch.zeros(4, 3)}
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(bad)


def test_checkpoint_save_snapshots_host_tensors(tmp_path, monkeypatch):
    """An async save holds the values of the moment it was called, even
    for host tensors updated in place before the write: the writer is held
    at its first file until the tree has changed."""
    from repro_torch.checkpoint import checkpointer as ckmod
    gate = threading.Event()
    real_save = np.save

    def held_save(f, arr):
        gate.wait(timeout=30)
        real_save(f, arr)

    monkeypatch.setattr(ckmod.np, "save", held_save)
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "h": torch.ones(4, dtype=torch.bfloat16),
            "t": torch.arange(6, dtype=torch.float32).reshape(3, 2).t()}
    want = [t.clone() for t in leaves(tree)]
    ck = Checkpointer(tmp_path)
    ck.save(1, tree)
    with torch.no_grad():
        for t in leaves(tree):
            t.add_(100)
    gate.set()
    ck.wait()
    got, _, _ = ck.restore({k: torch.zeros_like(v) for k, v in tree.items()})
    for a, b in zip(leaves(got), want):
        assert torch.equal(a, b)


# -------------------------------------------------------------- runner ---
def _runner(tmp_path, name, fail_at=()):
    def init_state():
        return init_train_state(TCFG, torch.Generator().manual_seed(0),
                                device="cpu")

    def data(start):
        return TokenStream(batch=4, seq=16, vocab=TCFG.vocab, seed=0,
                           start_step=start, device="cpu")

    step = make_train_step(TCFG, ca_k=2, peak_lr=1e-3, warmup=2,
                           total_steps=6, remat=True)
    return TrainingRunner(lambda rules: step, None, data, init_state,
                          tmp_path / name, ckpt_every=2,
                          failure_source=FailureSource(fail_at))


def test_runner_restarts_once_and_ends_where_an_uninterrupted_run_ends(
        tmp_path):
    plain = _runner(tmp_path, "plain")
    want = plain.run(6)
    failed = _runner(tmp_path, "failed", fail_at=[3])
    got = failed.run(6)
    assert plain.restarts == 0 and failed.restarts == 1
    assert [m["step"] for m in failed.metrics_log] == list(range(6))
    assert failed.metrics_log == plain.metrics_log
    for a, b in zip(leaves(list(got)), leaves(list(want))):
        assert torch.equal(a, b)
    assert failed.ckpt.latest_step() == 6
    with pytest.raises(NodeFailure):
        FailureSource([2]).maybe_fail(2)


def test_runner_restart_budget(tmp_path):
    r = _runner(tmp_path, "budget", fail_at=[1])
    r.max_restarts = 0
    with pytest.raises(RuntimeError, match="restart budget"):
        r.run(3)


# ----------------------------------------------------------------- CLI ---
def test_train_cli_on_cpu(tmp_path, capsys):
    kernels.reset_launch_counts()
    runner = train_cli.main(["--device", "cpu", "--preset", "tiny",
                             "--steps", "3", "--ckpt-dir",
                             str(tmp_path / "ck"), "--log-every", "1"])
    out = capsys.readouterr().out
    assert "restarts=0" in out and "(final)" in out
    assert len(runner.metrics_log) == 3
    assert all(np.isfinite(m["loss"]) for m in runner.metrics_log)
    assert kernels.launch_counts()["flash_dq"] == 0
    # a second run against the same directory has nothing to do
    again = train_cli.main(["--device", "cpu", "--preset", "tiny",
                            "--steps", "3", "--ckpt-dir",
                            str(tmp_path / "ck")])
    assert again.metrics_log == []
    assert os.path.isdir(tmp_path / "ck" / "step_3")


def test_train_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default runs on it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--preset", "tiny", "--steps", "1"])


# -------------------------------------------------------------- mamba2 ---
MCFG = jconfigs.smoke_config(jconfigs.get_arch("mamba2-780m"))
TMCFG = to_torch_config_arch(MCFG)


def _mamba_leaves(jax_tree):
    return leaves(params_from_numpy(TMCFG, _np_tree(jax_tree),
                                    dtype=torch.float32))


@pytest.mark.parametrize("remat", [False, True])
def test_mamba2_loss_fn_and_grads_match_jax(remat):
    """mamba2's loss and grads (the scan's backward through ``SSDFn``: the
    states sweep and the plain reverse scan) against ``jax.value_and_grad``
    of the JAX loss on the same float32 weights, at the JAX package's grad
    tolerance."""
    jp = j_init_params(MCFG, jax.random.PRNGKey(0))
    batch = _jax_batch(1, seq=70)              # not a chunk multiple
    with jregistry.use("xla"):
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: j_loss_fn(p, MCFG, batch, remat=remat)))(jp)
    params = params_from_numpy(TMCFG, _np_tree(jp), dtype=torch.float32)
    ps = [t.requires_grad_() for t in leaves(params)]
    loss = loss_fn(params, TMCFG, _to_port(batch), remat=remat)
    grads = torch.autograd.grad(loss, ps)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=SCALAR_RTOL)
    assert all(g.dtype == torch.float32 for g in grads)
    _close(grads, _mamba_leaves(jg), "grad", **GRAD_TOL)


def test_mamba2_remat_recomputes_the_scan():
    """Per-layer remat changes no number, and it runs ``ssd`` three times a
    layer (the forward, its recompute and the backward's states sweep)
    and ``ssd_bwd`` once; without remat the scan runs twice."""
    weights = _np_tree(j_init_params(MCFG, jax.random.PRNGKey(0)))
    batch = _to_port(_jax_batch(2))
    out = {}
    for remat in (False, True):
        p = params_from_numpy(TMCFG, weights, dtype=torch.float32)
        ps = [t.requires_grad_() for t in leaves(p)]
        registry.reset_dispatch_counts()
        loss = loss_fn(p, TMCFG, batch, remat=remat)
        out[remat] = (loss, torch.autograd.grad(loss, ps),
                      registry.dispatch_counts())
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)
    n = MCFG.n_layers
    assert out[False][2] == {("ssd", "torch"): 2 * n,
                             ("ssd_bwd", "torch"): n}
    assert out[True][2] == {("ssd", "torch"): 3 * n,
                            ("ssd_bwd", "torch"): n}


@pytest.mark.parametrize("classical", [False, True], ids=["ca2", "classical"])
def test_mamba2_train_steps_match_jax(classical):
    """One and three steps of the port's ``make_train_step`` (remat on, as
    the launcher runs it) against the JAX package's from the same state on
    the same batches: loss, grad norm, lr, the first moment and each
    leaf's update, held as ``test_train_steps_match_jax`` holds them. The
    CA step's bf16 compute copy rounds A_log and dt_bias as JAX's does."""
    kw = dict(ca_k=2, peak_lr=1e-3, warmup=0, total_steps=10)
    jstate = j_init_train_state(MCFG, jax.random.PRNGKey(0))
    state = train_state_from_numpy(TMCFG, _np_tree(jstate))
    params0 = [t.clone() for t in leaves(state.params)]
    with jregistry.use("xla"):
        jstep = jax.jit(j_make_train_step(
            MCFG, None, remat=False, sync_every_microbatch=classical, **kw))
    step = make_train_step(TMCFG, remat=True,
                           sync_every_microbatch=classical, **kw)
    m_tol = dict(atol=(1 - ADAM_B1) * GRAD_TOL["atol"],
                 rtol=GRAD_TOL["rtol"])
    for i in range(3):
        batch = _jax_batch(10 + i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, _to_port(batch))
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                       rtol=SCALAR_RTOL, err_msg=name)
        if i in (0, 2):
            _close(leaves(state.opt.m), _mamba_leaves(jstate.opt.m), "m",
                   **m_tol)
            rel = []
            for p, p0, w in zip(leaves(state.params), params0,
                                _mamba_leaves(jstate.params)):
                got, want = (p - p0).double(), (w - p0).double()
                rel.append(float((got - want).norm()
                                 / want.norm().clamp_min(1e-30)))
            assert max(rel) <= UPDATE_RTOL, (
                f"step {i + 1}: leaf {int(np.argmax(rel))} update off JAX's "
                f"by {max(rel):.3f} normwise (limit {UPDATE_RTOL})")


def test_mamba2_train_cli_restarts_once_and_matches_a_clean_run(tmp_path,
                                                                 capsys):
    """``--arch mamba2-780m --preset tiny --steps 12 --ckpt-every 4
    --fail-at 6`` on the CPU: one restart, and the metrics of every step
    bit-equal to a run with no failure."""
    runs = {}
    for label, extra in (("fail", ["--fail-at", "6"]), ("clean", [])):
        runs[label] = train_cli.main(
            ["--device", "cpu", "--arch", "mamba2-780m", "--preset", "tiny",
             "--steps", "12", "--ckpt-every", "4", "--ckpt-dir",
             str(tmp_path / label)] + extra)
    out = capsys.readouterr().out
    assert "restarts=1" in out and "restarts=0" in out
    assert runs["fail"].restarts == 1 and runs["clean"].restarts == 0
    assert len(runs["fail"].metrics_log) == 12
    assert runs["fail"].metrics_log == runs["clean"].metrics_log
    assert all(np.isfinite(m["loss"]) for m in runs["fail"].metrics_log)


def test_mamba2_train_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default runs on it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--arch", "mamba2-780m", "--preset", "tiny",
                        "--steps", "1"])


if __name__ == "__main__":
    # ROADMAP queue 3 item 6, not a test: mamba2's first-microbatch grad of
    # layer 0's A_log[4] under the classical schedule's first step, JAX's
    # and the port's with autograd's silu backward and with JAX's rule
    # (g s + (h g) (s (1 - s))), beside its value in a float32 stream, and
    # the worst leaf's first-step update against JAX's with each silu:
    #   PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/test_torch_train.py
    import types

    import repro_torch.models.mlp as tmlp
    import repro_torch.models.ssm as tssm
    import repro_torch.models.transformer as ttransformer

    class JaxSiLU(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h):
            ctx.save_for_backward(h)
            return h * torch.reciprocal(1 + torch.exp(-h))

        @staticmethod
        def backward(ctx, g):
            h, = ctx.saved_tensors
            s = torch.reciprocal(1 + torch.exp(-h))
            return g * s + (h * g) * (s * (1 - s))

    jstate = j_init_train_state(MCFG, jax.random.PRNGKey(0))
    batch = _jax_batch(10)
    mb = {k: v[:4] for k, v in batch.items()}
    with jregistry.use("xla"):
        jg = jax.jit(jax.grad(lambda p: j_loss_fn(p, MCFG, mb)))(
            jstate.params)
    want = _mamba_leaves(jg)[2]

    def port_grad():
        p = params_from_numpy(TMCFG, _np_tree(jstate.params),
                              dtype=torch.float32)
        ps = [t.requires_grad_() for t in leaves(p)]
        return torch.autograd.grad(loss_fn(p, TMCFG, _to_port(mb),
                                           remat=True), ps)[2]

    def first_update_rel():
        kw = dict(ca_k=2, peak_lr=1e-3, warmup=0, total_steps=10)
        with jregistry.use("xla"):
            js, _ = jax.jit(j_make_train_step(
                MCFG, None, remat=False, sync_every_microbatch=True,
                **kw))(jstate, batch)
        st = train_state_from_numpy(TMCFG, _np_tree(jstate))
        p0 = [t.clone() for t in leaves(st.params)]
        st, _ = make_train_step(TMCFG, remat=True,
                                sync_every_microbatch=True, **kw)(
            st, _to_port(batch))
        rel = [float(((p - q).double() - (w - q).double()).norm()
                     / (w - q).double().norm().clamp_min(1e-30))
               for p, q, w in zip(leaves(st.params), p0,
                                  _mamba_leaves(js.params))]
        return max(rel), int(np.argmax(rel))

    print(f"A_log[0][4] grad: JAX {float(want[4]):+.3e} (leaf max "
          f"{float(want.abs().max()):.3e})")
    print(f"  port, autograd's silu: {float(port_grad()[4]):+.3e}; first "
          f"update, worst leaf (rel, leaf): {first_update_rel()}")
    autograd_silu = tmlp.silu
    tmlp.silu = tssm.silu = JaxSiLU.apply
    print(f"  port, JAX's silu rule: {float(port_grad()[4]):+.3e}; first "
          f"update, worst leaf (rel, leaf): {first_update_rel()}")
    tmlp.silu = tssm.silu = autograd_silu

    class JaxSoftplus(torch.autograd.Function):
        """softplus with JAX's logaddexp rule: g exp(x - softplus(x))."""
        @staticmethod
        def forward(ctx, x):
            out = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))
            ctx.save_for_backward(x, out)
            return out

        @staticmethod
        def backward(ctx, g):
            x, out = ctx.saved_tensors
            return g * torch.exp(x - out)

    autograd_softplus, tssm._softplus = tssm._softplus, JaxSoftplus.apply
    print(f"  port, autograd's silu, JAX's softplus rule: "
          f"{float(port_grad()[4]):+.3e}")
    tssm._softplus = autograd_softplus
    shim = types.SimpleNamespace(**{k: getattr(torch, k) for k in dir(torch)
                                    if not k.startswith("__")})
    shim.bfloat16 = torch.float32
    ttransformer.torch = shim
    print(f"  port, float32 stream: {float(port_grad()[4]):+.3e}")

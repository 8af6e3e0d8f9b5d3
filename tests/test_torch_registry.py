"""The port's kernel registry: policy precedence, unknown backends, restore
on exception, the ``auto`` choice by device, dispatch counts, and no silent
fallback — a ``cuda`` impl that cannot run raises."""
import contextlib

import pytest
import torch

from repro_torch.kernels import registry
from repro_torch.kernels.prox_step.ops import prox_scalars


@pytest.fixture(autouse=True)
def clean_policy(monkeypatch):
    monkeypatch.delenv(registry.ENV_VAR, raising=False)
    registry.set_backend(None)
    yield
    registry.set_backend(None)


def test_ops_table():
    assert registry.ops() == ["flash_attention", "flash_dkv", "flash_dq",
                              "gram", "gram_gather", "paged_attention",
                              "pdhg_block", "prox_loop", "prox_loop_block",
                              "prox_step", "prox_step_block", "ssd",
                              "ssd_bwd"]


def test_policy_precedence(monkeypatch):
    assert registry.policy() == "auto"
    monkeypatch.setenv(registry.ENV_VAR, "cuda")
    assert registry.policy() == "cuda"
    registry.set_backend("torch")
    assert registry.policy() == "torch"
    with registry.use("cuda"):
        assert registry.policy() == "cuda"
        with registry.use("torch"):
            assert registry.policy() == "torch"
        assert registry.policy() == "cuda"
    assert registry.policy() == "torch"
    registry.set_backend(None)
    assert registry.policy() == "cuda"


def test_auto_resolves_by_device():
    assert registry.resolved_backend(torch.device("cpu")) == "torch"
    assert registry.resolved_backend(torch.device("cuda")) == "cuda"
    assert registry.resolved_backend(None) == "torch"
    with registry.use("cuda"):
        assert registry.resolved_backend(torch.device("cpu")) == "cuda"


@pytest.mark.parametrize("bad", ["xla", "pallas", "triton", ""])
def test_unknown_backend_rejected(bad, monkeypatch):
    with pytest.raises(ValueError, match="unknown backend"):
        registry.set_backend(bad)
    with pytest.raises(ValueError, match="unknown backend"):
        with registry.use(bad):
            pass
    monkeypatch.setenv(registry.ENV_VAR, bad or "nope")
    with pytest.raises(ValueError, match="unknown backend"):
        registry.policy()


def test_use_restores_on_exception():
    with pytest.raises(RuntimeError, match="boom"):
        with registry.use("cuda"):
            raise RuntimeError("boom")
    assert registry.policy() == "auto"


@pytest.mark.parametrize("how", ["use", "set_backend", "env"])
def test_cuda_with_cpu_tensors_raises_no_silent_fallback(how, monkeypatch):
    Xs = torch.ones(1, 4, 8)
    registry.reset_dispatch_counts()
    if how == "env":
        monkeypatch.setenv(registry.ENV_VAR, "cuda")
    elif how == "set_backend":
        registry.set_backend("cuda")
    with registry.use("cuda") if how == "use" else contextlib.nullcontext():
        with pytest.raises(RuntimeError, match="backend 'cuda' cannot run"):
            registry.dispatch("gram", Xs)
        with pytest.raises(RuntimeError, match="cannot run"):
            registry.dispatch("prox_step", torch.eye(4), torch.ones(4),
                              torch.ones(4), prox_scalars(0.1, 0.1))
    assert registry.dispatch_counts() == {}


def test_cuda_reason_names_the_missing_card_or_cpu_tensors():
    with registry.use("cuda"):
        with pytest.raises(RuntimeError) as info:
            registry.select("gram", torch.ones(1, 4, 8))
    msg = str(info.value)
    if not torch.cuda.is_available():
        assert "no CUDA device" in msg
    else:
        assert "needs CUDA tensors" in msg or "compute capability" in msg


def test_dispatch_counts_by_op_and_backend():
    registry.reset_dispatch_counts()
    Xs = torch.ones(2, 4, 8)
    for _ in range(3):
        registry.dispatch("gram", Xs)
    with registry.use("torch"):
        registry.dispatch("gram", Xs)
    assert registry.dispatch_counts() == {("gram", "torch"): 4}
    registry.reset_dispatch_counts()
    assert registry.dispatch_counts() == {}


def test_unknown_op():
    with pytest.raises(KeyError, match="unknown op"):
        registry.dispatch("no_such_op", torch.ones(2))


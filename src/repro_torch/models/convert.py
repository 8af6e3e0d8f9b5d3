"""Carry the JAX package's parameter tree, and its training state, into the
port's layout.

``repro.models.init_params`` returns nested dicts whose per-layer leaves
are stacked along a leading ``n_layers`` axis (``_stack_init``, for
``lax.scan``). :func:`params_from_numpy` takes that tree with every leaf a
numpy array (``jax.tree.map(np.asarray, params)``) and returns the port's
dict with ``layers`` a list of per-layer dicts, nested dicts (a dense
layer's ``attn`` and ``mlp``, an ssm layer's ``mamba``) carried as they
are.

The weights may be held in bf16 (the default) without changing a number
where the JAX model casts the float32 master to the bf16 stream before
every use: the dense family's projections, the embedding take, the logits
head and the norm gains, and mamba2's projections, convolution, D and norm.
mamba2 reads ``A_log`` and ``dt_bias`` in float32 (``repro/models/
ssm.py:78-80``), where a bf16 copy would round the decay of every step, so
those leaves (``models.ssm.FLOAT32_LEAVES``) stay float32 whatever
``dtype``. A training state keeps float32 masters
(:func:`train_state_from_numpy`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.ssm import FLOAT32_LEAVES
from repro_torch.models.transformer import require_supported
from repro_torch.tree import leaves


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def params_from_numpy(cfg, tree: dict, *, device=None,
                      dtype=torch.bfloat16) -> dict:
    """The JAX parameter tree of a family the port runs (numpy leaves,
    layers stacked) -> the port's parameter dict on ``device`` in
    ``dtype`` (``FLOAT32_LEAVES`` in float32)."""
    require_supported(cfg)

    def conv(sub, pick=lambda a: a, name=None):
        if isinstance(sub, dict):
            return {k: conv(v, pick, k) for k, v in sub.items()}
        keep = torch.float32 if name in FLOAT32_LEAVES else dtype
        return _tensor(pick(np.asarray(sub)), keep, device)

    stacked = tree["layers"]
    n = {np.asarray(a).shape[0] for a in leaves(stacked)}
    if n != {cfg.n_layers}:
        raise ValueError(f"tree has {sorted(n)} layers, {cfg.name} has "
                         f"{cfg.n_layers}")
    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [conv(stacked, lambda a, i=i: a[i])
                     for i in range(cfg.n_layers)]
    return out


def train_state_from_numpy(cfg, state, *, device=None):
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``: float32 params, ``opt.step``, ``opt.m``, ``opt.v``) -> the
    port's ``repro_torch.launch.steps.TrainState`` on ``device``, every
    tensor float32 but the int32 step."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim import OptState

    def tree(t):
        return params_from_numpy(cfg, t, device=device, dtype=torch.float32)

    step = torch.tensor(int(np.asarray(state.opt.step)), dtype=torch.int32,
                        device=device)
    return TrainState(params=tree(state.params),
                      opt=OptState(step=step, m=tree(state.opt.m),
                                   v=tree(state.opt.v)))

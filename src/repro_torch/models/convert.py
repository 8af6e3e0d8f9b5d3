"""Carry the JAX package's parameter tree, and its training state, into the
port's layout.

``repro.models.init_params`` returns nested dicts whose per-layer leaves
are stacked along a leading ``n_layers`` axis (``_stack_init``, for
``lax.scan``). :func:`params_from_numpy` takes that tree with every leaf a
numpy array (``jax.tree.map(np.asarray, params)``) and returns the port's
dict with ``layers`` a list of per-layer dicts.

The weights may be held in bf16 (the default) without changing a number:
every use of a weight in the JAX model casts the float32 master to the bf16
stream first (``blocks.py`` projections, ``mlp.py``, the embedding take and
the logits head in ``transformer.py``, the norm gains in ``layers.py``), so
bf16 weights here give the products JAX computes. A training state keeps
float32 masters (:func:`train_state_from_numpy`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import require_dense


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def params_from_numpy(cfg, tree: dict, *, device=None,
                      dtype=torch.bfloat16) -> dict:
    """The JAX dense parameter tree (numpy leaves, layers stacked) -> the
    port's parameter dict on ``device`` in ``dtype``."""
    require_dense(cfg)

    def conv(sub):
        if isinstance(sub, dict):
            return {k: conv(v) for k, v in sub.items()}
        return _tensor(sub, dtype, device)

    stacked = tree["layers"]
    n = np.asarray(stacked["ln1"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} layers, {cfg.name} has "
                         f"{cfg.n_layers}")

    def layer(i, sub):
        if isinstance(sub, dict):
            return {k: layer(i, v) for k, v in sub.items()}
        return _tensor(np.asarray(sub)[i], dtype, device)

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [layer(i, stacked) for i in range(n)]
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

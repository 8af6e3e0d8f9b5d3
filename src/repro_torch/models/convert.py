"""Carry the JAX package's parameter tree into the port's layout.

``repro.models.init_params`` returns nested dicts whose per-layer leaves
are stacked along a leading ``n_layers`` axis (``_stack_init``, for
``lax.scan``). :func:`params_from_numpy` takes that tree with every leaf a
numpy array (``jax.tree.map(np.asarray, params)``) and returns the port's
dict with ``layers`` a list of per-layer dicts.

The weights may be held in bf16 (the default) without changing a number:
every use of a weight in the JAX model casts the float32 master to the bf16
stream first (``blocks.py`` projections, ``mlp.py``, the embedding take and
the logits head in ``transformer.py``, the norm gains in ``layers.py``), so
bf16 weights here give the products JAX computes.
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

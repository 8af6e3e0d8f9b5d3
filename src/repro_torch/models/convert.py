"""Carry the JAX package's parameter tree, and its training state, into the
port's layout.

``repro.models.init_params`` returns nested dicts whose per-layer leaves
are stacked along a leading axis (``_stack_init``, for ``lax.scan``).
:func:`params_from_numpy` takes that tree with every leaf a numpy array
(``jax.tree.map(np.asarray, params)``) and returns the port's dict
(``repro_torch.models.transformer``): ``layers`` becomes a list of
per-layer dicts (zamba2's, stacked (n_super, period, ...), a list of
``n_super`` lists of ``period`` dicts), whisper's ``encoder`` a list of
``n_enc_layers`` dicts, and the unstacked entries (``embed``, ``ln_f``,
``lm_head``, deepseek's ``dense0``, zamba2's ``shared``, ``enc_ln``) are
carried as they are. :func:`shard_state_from_numpy` cuts a JAX training
state into one rank's shard of the port's sharded state instead, its
stacks kept stacked.

The weights may be held in bf16 (the default) without changing a number
where the JAX model casts the float32 master to the bf16 stream before
every use: the projections, the embedding take, the logits head, the norm
gains and biases, MoE experts, and mamba2's convolution, D and norm. Two
kinds of leaf are read in float32 and stay float32 whatever ``dtype``
(``FLOAT32_LEAVES``): mamba2's ``A_log`` and ``dt_bias``
(``repro/models/ssm.py:78-80``), in zamba2's layers too, where a bf16
copy would round the decay of every step, and the MoE ``router``
(``repro/models/moe.py:77-78``), whose rounding would move the routing. A
training state keeps float32 masters (:func:`train_state_from_numpy`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import moe, ssm
from repro_torch.models.transformer import require_supported
from repro_torch.tree import leaves

#: the leaves held in float32 in a tree of any dtype
FLOAT32_LEAVES = ssm.FLOAT32_LEAVES + moe.FLOAT32_LEAVES


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _stacked(cfg) -> dict:
    """The stacked entries of the family's JAX tree and their leading
    shape."""
    fam = cfg.family
    if fam == "hybrid":
        return {"layers": (cfg.n_layers // cfg.shared_attn_period,
                           cfg.shared_attn_period)}
    n = cfg.n_layers - int(fam == "moe" and cfg.first_layer_dense)
    if fam == "audio":
        return {"layers": (n,), "encoder": (cfg.n_enc_layers,)}
    return {"layers": (n,)}


def params_from_numpy(cfg, tree: dict, *, device=None,
                      dtype=torch.bfloat16) -> dict:
    """The JAX parameter tree of any family (numpy leaves, layers stacked)
    -> the port's parameter dict on ``device`` in ``dtype``
    (``FLOAT32_LEAVES`` in float32). Raises when a stacked entry's leaves
    do not lead with the config's layer counts."""
    require_supported(cfg)

    def conv(sub, pick=lambda a: a, name=None):
        if isinstance(sub, dict):
            return {k: conv(v, pick, k) for k, v in sub.items()}
        keep = torch.float32 if name in FLOAT32_LEAVES else dtype
        return _tensor(pick(np.asarray(sub)), keep, device)

    stacked = _stacked(cfg)
    out = {k: conv(v) for k, v in tree.items() if k not in stacked}
    for key, lead in stacked.items():
        found = {np.asarray(a).shape[:len(lead)] for a in leaves(tree[key])}
        if found != {lead}:
            raise ValueError(f"{key}: tree leads with {sorted(found)}, "
                             f"{cfg.name} has {lead}")
        if len(lead) == 1:
            out[key] = [conv(tree[key], lambda a, i=i: a[i])
                        for i in range(lead[0])]
        else:
            out[key] = [[conv(tree[key], lambda a, i=i, j=j: a[i, j])
                         for j in range(lead[1])] for i in range(lead[0])]
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


def shard_state_from_numpy(cfg, state, rules, *, coords=None, device=None):
    """A JAX ``TrainState`` with numpy leaves (its layers stacked, as the
    port's sharded state holds them) -> one rank's shard of it under
    ``rules``: the port's ``TrainState`` of float32 shards (and the int32
    step) in JAX's stacked layout, each cut where ``NamedSharding`` puts
    the shard of the device at ``coords`` (default: this rank's,
    ``rules.coords``). A cold start off the card draws nothing there."""
    from repro_torch.dist.sharding import shard_tensor
    from repro_torch.launch.steps import TrainState, layout
    from repro_torch.optim import OptState

    lay = layout(cfg, rules)
    coords = rules.coords if coords is None else coords

    def tree(t):
        got = leaves(t)
        if len(got) != len(lay.leaves):
            raise ValueError(f"{cfg.name}: {len(got)} leaves, the layout "
                             f"has {len(lay.leaves)}")
        out = []
        for a, lf in zip(got, lay.leaves):
            a = np.asarray(a)
            if tuple(a.shape) != lf.shape:
                raise ValueError(f"leaf {a.shape}, the layout's {lf.shape}")
            out.append(_tensor(shard_tensor(a, lf.spec, rules.mesh, coords),
                               torch.float32, device))
        return lay.tree(out)

    step = torch.tensor(int(np.asarray(state.opt.step)), dtype=torch.int32,
                        device=device)
    return TrainState(params=tree(state.params),
                      opt=OptState(step=step, m=tree(state.opt.m),
                                   v=tree(state.opt.v)))

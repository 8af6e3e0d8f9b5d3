"""AdamW with float32 master weights and moments (the counterpart of
``repro.optim.adamw``): the same constants, global-norm clipping and
bias correction.

The state mirrors the parameter tree: ``m`` and ``v`` have one float32
tensor per parameter. The step counter lives on the device, so an update
reads nothing back to the host.

Unlike the JAX version, which is pure, :func:`adamw_update` writes the new
parameters, m and v into the tensors it is given (under ``torch.no_grad``)
and returns them: at full width a second copy of masters and moments would
cost another 22.7 GB on the card.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor   # () int32, on the device
    m: Any
    v: Any


def adamw_init(params) -> OptState:
    first = leaves(params)[0]
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=first.device),
                    m=tree_map(torch.zeros_like, params),
                    v=tree_map(torch.zeros_like, params))


@torch.no_grad()
def adamw_update(params, grads, state: OptState, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0,
                 gnorm=None):
    """One AdamW step, in place: returns (params, OptState, grad norm), the
    params, m and v being the tensors passed in, updated. ``lr`` may be a
    float or a device scalar (a schedule value). ``grads`` mirrors
    ``params`` in any float dtype; the update runs in float32. ``gnorm``:
    the global gradient norm, when the caller computed it (a sharded step,
    from every rank's shards); by default that of ``grads``."""
    ps, gs = leaves(params), leaves(grads)
    ms, vs = leaves(state.m), leaves(state.v)
    if gnorm is None:
        gnorm = torch.sqrt(sum(torch.dot(g.float().reshape(-1),
                                         g.float().reshape(-1)) for g in gs))
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(ps, gs, ms, vs):
        g = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        p.copy_((p - lr * (u + weight_decay * p)).to(p.dtype))
    return params, OptState(step=step, m=state.m, v=state.v), gnorm

"""Sharding rules as shape logic: logical axes and FSDP/TP spec inference,
the counterpart of ``repro.dist.sharding``.

``Rules`` binds a mesh to two logical axes:

- ``dp`` — the data-parallel axes (``"data"``, or ``("pod", "data")`` on the
  multi-pod mesh): batch dims and the FSDP shard dim of parameters;
- ``tp`` — the tensor-parallel axis (``"model"``): hidden/vocab/head dims and
  the KV-cache sequence dim (flash-decoding layout);

and carries the data-parallel process group (``None`` at world 1) that the
train step reduces its gradients over.

The port has no device mesh: a :class:`Mesh` is axis names and sizes, and
a spec is a tuple of entries (``None``, an axis name or a tuple of names),
one per dim, where JAX has a ``PartitionSpec``. The inference is JAX's:
every candidate spec passes through :func:`fit_spec`, which keeps the
longest prefix of each axis group that divides the dim. Applying the specs
to tensors (DTensor or FSDP) is not done yet (ROADMAP queue 1 item 7): the
port trains data-parallel over replicated masters, and :meth:`Rules.constrain`
is the identity, as JAX's is on one chip.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple, Union

Entry = Union[str, Tuple[str, ...], None]
Spec = Tuple[Entry, ...]

# Leaves smaller than this stay replicated: sharding a 64 KiB tensor buys
# nothing and costs a collective per use.
_MIN_SHARD_BYTES_ELEMS = 1 << 16


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh's shape: axis names and their sizes, outermost first."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"mesh: {self.axis_names} against sizes "
                             f"{self.sizes}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def _axes_of(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _pack(axes: Tuple[str, ...]) -> Entry:
    if not axes:
        return None
    if len(axes) == 1:
        return axes[0]
    return tuple(axes)


def fit_spec(spec: Spec, shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    """Degrade ``spec`` until it divides ``shape`` on ``mesh``.

    Per dim: keep the longest prefix of the entry's axis group whose combined
    size divides the dim; an empty prefix becomes ``None`` (replicated), a
    1-axis prefix is unwrapped to the bare name. Dims beyond ``len(spec)``
    are implicitly replicated; entries beyond ``len(shape)`` are dropped.
    """
    sizes = mesh.shape
    out = []
    for dim, entry in zip(shape, tuple(spec)):
        kept: Tuple[str, ...] = ()
        size = 1
        for ax in _axes_of(entry):
            nxt = size * sizes[ax]
            if dim % nxt != 0:
                break
            kept = kept + (ax,)
            size = nxt
        out.append(_pack(kept))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Rules:
    """Mesh + logical-axis translation, and the data-parallel group."""
    mesh: Mesh
    dp: Entry           # data-parallel axes ("data" or ("pod", "data"))
    tp: Optional[str]   # tensor-parallel axis ("model"), if the mesh has one
    group: Any = None   # the data-parallel process group; None at world 1

    @property
    def n_devices(self) -> int:
        return math.prod(self.mesh.sizes)

    @property
    def dp_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in _axes_of(self.dp))

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[self.tp] if self.tp else 1

    def logical_spec(self, logical) -> Spec:
        """Translate a logical-axis tuple ("batch" | "tp" | None per dim)."""
        table = {"batch": self.dp, "tp": self.tp, None: None}
        return tuple(table.get(name) for name in logical)

    def constrain(self, x, logical):
        """The identity: the port places no tensor by spec yet."""
        return x


def make_rules(mesh: Mesh, group=None) -> Rules:
    """Bind rules to a mesh: ``model`` (if present) is tensor-parallel, every
    other axis is data-parallel in mesh order (``pod`` outermost).
    ``group``: the process group of the data-parallel ranks."""
    tp = "model" if "model" in mesh.axis_names else None
    dp_axes = tuple(a for a in mesh.axis_names if a != tp)
    return Rules(mesh=mesh, dp=_pack(dp_axes), tp=tp, group=group)


def data_rules(group=None) -> Rules:
    """Rules over a data-only mesh of ``group``'s ranks (world 1 and no
    group when ``group`` is None and no process group is initialized)."""
    import torch.distributed as dist
    world = (dist.get_world_size(group)
             if group is not None or dist.is_initialized() else 1)
    return make_rules(Mesh(("data",), (world,)), group=group)


# ---------------------------------------------------------------------------
# parameter specs (FSDP x TP)
# ---------------------------------------------------------------------------

def _param_leaf_spec(shape: Tuple[int, ...], rules: Rules,
                     gather_fsdp: bool) -> Spec:
    """Megatron-style 2-D sharding inferred from shape alone.

    The largest dim divisible by the tp size carries the model axis (ties go
    to the later dim: output/vocab projections shard on their last dim); the
    largest remaining dim carries the FSDP axes. fit_spec degrades anything
    that doesn't divide.
    """
    nd = len(shape)
    size = math.prod(shape)
    if nd < 2 or size < _MIN_SHARD_BYTES_ELEMS or rules.n_devices <= 1:
        return (None,) * nd

    order = sorted(range(nd), key=lambda i: (shape[i], i), reverse=True)
    entries: list = [None] * nd

    tp_dim = None
    if rules.tp is not None:
        tp_sz = rules.tp_size
        tp_dim = next((i for i in order
                       if shape[i] >= tp_sz and shape[i] % tp_sz == 0), None)
        if tp_dim is not None:
            entries[tp_dim] = rules.tp

    if rules.dp is not None and not gather_fsdp:
        dp_total = rules.dp_size
        rest = [i for i in order if i != tp_dim]
        dp_dim = next((i for i in rest
                       if shape[i] >= dp_total and shape[i] % dp_total == 0),
                      rest[0] if rest else None)
        if dp_dim is not None:
            entries[dp_dim] = rules.dp

    return fit_spec(tuple(entries), shape, rules.mesh)


def _stack_depth(sub) -> Tuple[int, ...]:
    """The leading shape of a layer stack: a list of per-layer trees
    (zamba2: a list of lists)."""
    if isinstance(sub, list) and sub:
        return (len(sub),) + _stack_depth(sub[0])
    return ()


def param_specs(params, rules: Rules, *, gather_fsdp: bool = False):
    """A spec tree for ``params`` (tensors, any device, ``meta`` too), in
    JAX's stacked layout: a layer stack, which the port holds as a list of
    per-layer trees (zamba2: a list of lists), gets one tree of specs for
    the stack as a whole, each leading with the stack dims, as JAX's
    stacked leaf does (JAX shards some stacks' leading dim, e.g. an (L, d)
    norm gain's L over the data axes). gather_fsdp=True drops the data
    axes and keeps the tp axes — the layout of the bf16 compute copy.
    """
    def spec(sub, lead):
        if isinstance(sub, dict):
            return {k: spec(v, lead) for k, v in sub.items()}
        return _param_leaf_spec(tuple(lead) + tuple(sub.shape), rules,
                                gather_fsdp)

    def walk(sub):
        if isinstance(sub, dict):
            return {k: walk(v) for k, v in sub.items()}
        if isinstance(sub, list):
            lead, layer = _stack_depth(sub), sub
            while isinstance(layer, list):
                layer = layer[0]
            return spec(layer, lead)
        return spec(sub, ())
    return walk(params)


# ---------------------------------------------------------------------------
# decode-cache specs
# ---------------------------------------------------------------------------

def _cache_leaf_spec(name, shape: Tuple[int, ...], rules: Rules) -> Spec:
    """Cache layout by leaf name (trailing dims are fixed per kind):

    - k/v   (..., B, S, H_kv, D_h): batch@dp, seq@tp (flash decoding); a
            paged pool's (num_pages, page_size) take (B, S)'s places;
    - ssm   (..., B, H, P, N):      batch@dp, heads@tp (degradable);
    - k_scale/v_scale: their parent's rule one axis left;
    - conv  (..., B, K-1, ch):      batch@dp;
    - everything else (pos, ...):   replicated.
    """
    nd = len(shape)
    entries: list = [None] * nd
    if name in ("k", "v", "ssm") and nd >= 4:
        entries[nd - 4] = rules.dp
        entries[nd - 3] = rules.tp
    elif name in ("k_scale", "v_scale") and nd >= 3:
        entries[nd - 3] = rules.dp
        entries[nd - 2] = rules.tp
    elif name == "conv" and nd >= 3:
        entries[nd - 3] = rules.dp
    return fit_spec(tuple(entries), shape, rules.mesh)


def cache_specs(cache, rules: Rules):
    """A spec tree for a decode cache from ``init_cache``: each leaf by
    the name of the innermost dict key above it."""
    def walk(sub, name):
        if isinstance(sub, dict):
            return {k: walk(v, k) for k, v in sub.items()}
        if isinstance(sub, (list, tuple)):
            return type(sub)(walk(v, name) for v in sub)
        return _cache_leaf_spec(name, tuple(sub.shape), rules)
    return walk(cache, None)

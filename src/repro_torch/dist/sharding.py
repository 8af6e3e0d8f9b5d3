"""Sharding rules and their application to tensors, the counterpart of
``repro.dist.sharding``.

``Rules`` binds a mesh to two logical axes:

- ``dp`` — the data-parallel axes (``"data"``, or ``("pod", "data")`` on the
  multi-pod mesh): batch dims and the FSDP shard dim of parameters;
- ``tp`` — the tensor-parallel axis (``"model"``): hidden/vocab/head dims and
  the KV-cache sequence dim (flash-decoding layout);

and, bound to a process group (:func:`make_rules` with ``group``), carries
this rank's place on the mesh and the groups of its data axes and of its
model axis (with the model group's 1-D ``DeviceMesh`` for DTensor).

A :class:`Mesh` is axis names and sizes, and a spec is a tuple of entries
(``None``, an axis name or a tuple of names), one per dim, where JAX has a
``PartitionSpec``. The inference is JAX's: every candidate spec passes
through :func:`fit_spec`, which keeps the longest prefix of each axis group
that divides the dim, so every shard of a leaf has the same shape. Ranks
lie on the mesh in JAX's device order (``np.array(devices).reshape(mesh
shape)``): rank r is device r (:func:`shard_coords`), and
:func:`shard_shape` and :func:`shard_slice` are ``NamedSharding``'s shard
shape and the cut of its ``addressable_shards``.

:class:`Layout` applies the specs to a training state: the float32
masters (and AdamW's moments) are held in JAX's stacked layout, one tensor
a stacked leaf, each rank its shard under ``param_specs(..., rules)``; a
step all-gathers them once over the data group into the bf16 compute copy
in the ``gather_fsdp`` layout (one flat buffer, one collective) and
reduce-scatters a microbatch's gradients in that layout back to the
shards (one flat buffer, one collective). :meth:`Rules.constrain` is the
identity: the dense model's tensor-parallel layout is set where it
computes (``repro_torch.models.tp``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Optional, Tuple, Union

import torch

from repro_torch import Unsupported
from repro_torch.roofline import category
from repro_torch.tree import leaves, unflatten

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
    """Mesh + logical-axis translation and, bound to a process group, this
    rank's place on the mesh and its groups."""
    mesh: Mesh
    dp: Entry           # data-parallel axes ("data" or ("pod", "data"))
    tp: Optional[str]   # tensor-parallel axis ("model"), if the mesh has one
    group: Any = None   # the process group over the mesh's ranks; None: none
    rank: int = 0       # this rank's index on the mesh (its rank in group)
    dp_group: Any = None    # the ranks that differ from it only in data
    tp_group: Any = None    # those differing only in model (tp_size > 1)
    tp_mesh: Any = None     # tp_group's 1-D DeviceMesh

    @property
    def n_devices(self) -> int:
        return math.prod(self.mesh.sizes)

    @property
    def dp_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in _axes_of(self.dp))

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[self.tp] if self.tp else 1

    @property
    def coords(self) -> Tuple[int, ...]:
        return shard_coords(self, self.rank)

    @property
    def dp_rank(self) -> int:
        """This rank's index along the data axes (its rank in dp_group)."""
        at = dict(zip(self.mesh.axis_names, self.coords))
        return _ravel(_axes_of(self.dp), at, self.mesh.shape)

    @property
    def tp_rank(self) -> int:
        return (self.coords[self.mesh.axis_names.index(self.tp)]
                if self.tp else 0)

    def logical_spec(self, logical) -> Spec:
        """Translate a logical-axis tuple ("batch" | "tp" | None per dim)."""
        table = {"batch": self.dp, "tp": self.tp, None: None}
        return tuple(table.get(name) for name in logical)

    def constrain(self, x, logical):
        """The identity (see the module docstring)."""
        return x


def _ravel(axes, at: dict, sizes: dict) -> int:
    """The index along an axis group, its first axis the major one (how
    ``NamedSharding`` orders a dim sharded over several axes)."""
    idx = 0
    for ax in axes:
        idx = idx * sizes[ax] + at[ax]
    return idx


def shard_coords(rules: Rules, rank: int) -> Tuple[int, ...]:
    """Rank ``rank``'s coordinates on ``rules.mesh`` in JAX's device order:
    the mesh is ``np.array(range(n)).reshape(sizes)``."""
    out = []
    for size in reversed(rules.mesh.sizes):
        out.append(rank % size)
        rank //= size
    return tuple(reversed(out))


def _entries(spec: Spec, ndim: int) -> Tuple[Entry, ...]:
    return tuple(spec) + (None,) * (ndim - len(spec))


def shard_shape(shape, spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of each shard of a ``shape`` leaf laid out by ``spec``
    (``NamedSharding(mesh, spec).shard_shape(shape)``)."""
    sizes = mesh.shape
    return tuple(dim // math.prod(sizes[a] for a in _axes_of(e))
                 for dim, e in zip(shape, _entries(spec, len(shape))))


def shard_slice(shape, spec: Spec, mesh: Mesh,
                coords: Tuple[int, ...]) -> Tuple[slice, ...]:
    """Where the shard of the device at ``coords`` lies in the full leaf:
    one slice a dim, as ``addressable_shards`` cut it."""
    sizes, at = mesh.shape, dict(zip(mesh.axis_names, coords))
    out = []
    for size, e in zip(shard_shape(shape, spec, mesh),
                       _entries(spec, len(shape))):
        i = _ravel(_axes_of(e), at, sizes)
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def shard_tensor(full, spec: Spec, mesh: Mesh, coords: Tuple[int, ...]):
    """The shard of ``full`` (a tensor or an array) at ``coords``: a view."""
    return full[shard_slice(tuple(full.shape), spec, mesh, coords)]


def make_rules(mesh: Mesh, group=None) -> Rules:
    """Bind rules to a mesh: ``model`` (if present) is tensor-parallel, every
    other axis is data-parallel in mesh order (``pod`` outermost).

    ``group``: the process group whose ranks lie on the mesh, rank r at
    :func:`shard_coords` of r; its size must be the mesh's. The rules then
    carry this rank's data group (the ranks that differ from it only along
    the data axes) and model group (only along ``model``), each built by
    its members alone (``use_local_synchronization``), ``group`` itself
    where it has the same ranks, and, for a model axis past 1, the model
    group's ``DeviceMesh``."""
    tp = "model" if "model" in mesh.axis_names else None
    dp_axes = tuple(a for a in mesh.axis_names if a != tp)
    rules = Rules(mesh=mesh, dp=_pack(dp_axes), tp=tp)
    if group is None:
        return rules
    import torch.distributed as dist
    world = dist.get_world_size(group)
    if world != rules.n_devices:
        raise ValueError(f"rules: a mesh of {rules.n_devices} devices "
                         f"{mesh.sizes} over a group of {world} ranks")
    members = dist.get_process_group_ranks(group)
    rank = dist.get_rank(group)
    me = shard_coords(rules, rank)

    def along(axes):
        ranks = [members[r] for r in range(world)
                 if all(c == m for ax, c, m in
                        zip(mesh.axis_names, shard_coords(rules, r), me)
                        if ax not in axes)]
        if ranks == list(members):
            return group
        return dist.new_group(ranks=ranks, use_local_synchronization=True)
    dp_group = along(dp_axes)
    tp_group = tp_mesh = None
    if rules.tp_size > 1:
        tp_group = along((tp,))
        from torch.distributed.device_mesh import DeviceMesh
        kind = "cuda" if dist.get_backend(tp_group) == "nccl" else "cpu"
        # the dim named after the group: DTensor keys its cached plans by
        # meshes, which compare by ranks and names, so a mesh over another
        # group of the same ranks (a later process group's) finds none
        tp_mesh = DeviceMesh.from_group(
            tp_group, kind, mesh_dim_names=(tp_group.group_name,))
    return dataclasses.replace(rules, group=group, rank=rank,
                               dp_group=dp_group, tp_group=tp_group,
                               tp_mesh=tp_mesh)


def data_rules(group=None) -> Rules:
    """Rules over a data-only mesh of ``group``'s ranks: FSDP over the data
    axis, as JAX's rules give on a ``("data",)`` mesh (world 1 and no
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
# the specs applied to a parameter tree
# ---------------------------------------------------------------------------

def _spec_leaves(tree) -> list:
    """A spec tree's specs in :func:`repro_torch.tree.leaves` order."""
    if isinstance(tree, dict):
        return [s for key in sorted(tree) for s in _spec_leaves(tree[key])]
    return [tree]


def _layers(sub, depth: int) -> list:
    """A stack's per-layer trees, row-major over its ``depth`` lead dims."""
    return [t for s in sub for t in _layers(s, depth - 1)] if depth else [sub]


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """One stacked leaf under the rules: its global shape, its sharded
    (FSDP x TP) and gathered (TP) specs, the shapes this rank holds of
    each, the dim split over the data axes (None: replicated over them)
    and the number of stack dims leading its shape."""
    shape: Tuple[int, ...]
    spec: Spec
    gspec: Spec
    local: Tuple[int, ...]
    glocal: Tuple[int, ...]
    data_dim: Optional[int]
    lead: int

    @property
    def numel(self) -> int:
        return math.prod(self.local)

    @property
    def gnumel(self) -> int:
        return math.prod(self.glocal)

    @property
    def model_dim(self) -> Optional[int]:
        """The dim split over the model axis in the compute copy."""
        return next((i for i, e in enumerate(self.gspec) if e is not None),
                    None)


class Layout:
    """The layout of a parameter tree under ``rules``: JAX's stacked tree
    (:attr:`like`, a shape record a leaf), each stacked leaf's
    :class:`LeafLayout` in :func:`repro_torch.tree.leaves` order, and the
    flat buffers of the step's collectives.

    ``params``: the port's parameter tree (layer stacks as lists of
    per-layer trees), on any device, ``meta`` too. A leaf sharded over the
    data axes sits in the all-gather's buffer (this rank's shard) and the
    reduce-scatter's (one slot a data rank); a leaf replicated over them
    (its spec names no data axis) is cast in place for the compute copy,
    and its gradients are summed by an all-reduce of
    :meth:`replicated_buffer`. ``training`` False: a layout of the
    compute copy alone (serving's weights), which no flat collective
    gathers, so a leaf may split over a part of the data axes."""

    def __init__(self, params: dict, rules: Rules, training: bool = True):
        self.rules = rules
        self.depths = {k: _stack_depth(v) for k, v in params.items()
                       if isinstance(v, list)}
        self.layer_like = {k: _layers(params[k], len(d))[0]
                           for k, d in self.depths.items()}
        specs = _spec_leaves(param_specs(params, rules))
        gspecs = _spec_leaves(param_specs(params, rules, gather_fsdp=True))
        like, self.leaves = {}, []
        metas = []
        for key in sorted(params):
            lead = self.depths.get(key, ())
            sub = self.layer_like[key] if lead else params[key]
            like[key] = _meta_like(sub, lead)
            metas += leaves(like[key])
        self.like = like
        dp_axes = set(_axes_of(rules.dp))
        for t, spec, gspec in zip(metas, specs, gspecs):
            shape = tuple(t.shape)
            ddim = next((i for i, (a, b) in enumerate(zip(spec, gspec))
                         if a != b), None)
            self.leaves.append(LeafLayout(
                shape=shape, spec=spec, gspec=gspec,
                local=shard_shape(shape, spec, rules.mesh),
                glocal=shard_shape(shape, gspec, rules.mesh),
                data_dim=ddim, lead=t.lead))
            if ddim is not None and set(_axes_of(spec[ddim])) != dp_axes \
                    and rules.group is not None and training:
                raise Unsupported(
                    f"a leaf {shape} split over a part of the data axes "
                    f"({spec}): the flat collectives take whole data groups")
        self.sharded = [i for i, lf in enumerate(self.leaves)
                        if lf.data_dim is not None]
        self.replicated = [i for i, lf in enumerate(self.leaves)
                           if lf.data_dim is None]
        self._off = {}
        off = 0
        for i in self.sharded:
            self._off[i] = off
            off += self.leaves[i].numel
        self.n_sharded = off      # one data rank's slot of the collectives
        self.n_replicated = sum(self.leaves[i].gnumel
                                for i in self.replicated)

    # ------------------------------------------------------------- trees
    def tree(self, flat):
        """JAX's stacked tree over ``flat`` (a tensor a stacked leaf)."""
        return unflatten(self.like, flat)

    def unstack(self, flat, wrap=None) -> dict:
        """The port's parameter tree over ``flat`` (a tensor a stacked
        leaf, full along the stack dims): each layer's leaves are views of
        the stacked tensors, ``wrap(view, leaf_layout)`` when given. The
        views come from one ``unbind`` a stack dim, whose backward stacks
        the layers' gradients in one op (indexing a layer at a time would
        add a zero-padded copy of the whole stack a layer)."""
        wrap = wrap or (lambda t, lf: t)
        out, i = {}, 0
        for key in sorted(self.like):
            n = len(leaves(self.like[key]))
            chunk, lays = flat[i:i + n], self.leaves[i:i + n]
            i += n
            lead = self.depths.get(key)
            if not lead:
                out[key] = unflatten(self.like[key],
                                     [wrap(t, lf) for t, lf in
                                      zip(chunk, lays)])
                continue
            parts = [t.unbind(0) if len(lead) == 1 else
                     [p.unbind(0) for p in t.unbind(0)] for t in chunk]

            def layer(pick, parts=parts, lays=lays, key=key):
                return unflatten(self.layer_like[key],
                                 [wrap(pick(p), lf) for p, lf in
                                  zip(parts, lays)])
            if len(lead) == 1:
                out[key] = [layer(lambda p, a=a: p[a])
                            for a in range(lead[0])]
            else:
                out[key] = [[layer(lambda p, a=a, b=b: p[a][b])
                             for b in range(lead[1])]
                            for a in range(lead[0])]
        return out

    def shard(self, params: dict, coords=None, gathered: bool = False
              ) -> list:
        """This rank's shard of every stacked leaf of ``params`` (the port's
        tree, full), as new tensors of the params' dtype and device; with
        ``gathered``, in the ``gather_fsdp`` layout (split over the model
        axis only: the compute copy's, and serving's)."""
        coords = self.rules.coords if coords is None else coords
        mesh, out = self.rules.mesh, []
        srcs = []
        for key in sorted(params):
            if key in self.depths:
                per = [leaves(t) for t in
                       _layers(params[key], len(self.depths[key]))]
                srcs += [[p[j] for p in per] for j in range(len(per[0]))]
            else:
                srcs += leaves(params[key])
        for src, lf in zip(srcs, self.leaves):
            spec, local = (lf.gspec, lf.glocal) if gathered \
                else (lf.spec, lf.local)
            cut = shard_slice(lf.shape, spec, mesh, coords)
            if not lf.lead:
                out.append(src[cut].clone())
                continue
            first = src[0]
            shard = torch.empty(local, dtype=first.dtype,
                                device=first.device)
            lead = lf.shape[:lf.lead]
            for idx in itertools.product(*(range(c.start, c.stop)
                                           for c in cut[:lf.lead])):
                flat = idx[0] if lf.lead == 1 else idx[0] * lead[1] + idx[1]
                at = tuple(i - c.start for i, c in zip(idx, cut))
                shard[at].copy_(src[flat][cut[lf.lead:]])
            out.append(shard)
        return out

    def counted(self) -> list:
        """Whether this rank counts each leaf in a global sum over ranks
        (a norm): a leaf replicated over an axis counts once, on the ranks
        at index 0 of every axis its spec does not split."""
        at = dict(zip(self.rules.mesh.axis_names, self.rules.coords))
        return [all(at[ax] == 0 for ax in self.rules.mesh.axis_names
                    if ax not in {a for e in lf.spec for a in _axes_of(e)})
                for lf in self.leaves]

    # ------------------------------------------------------- collectives
    def gather(self, shards, dtype, counter=None) -> list:
        """The compute copy: every leaf in the ``gather_fsdp`` layout in
        ``dtype``, views of one buffer. The leaves split over the data axes
        come from one ``all_gather_into_tensor`` of one flat buffer of this
        rank's shards over the data group (none when no leaf is split);
        the others are cast from the rank's own master."""
        dev = shards[0].device
        with category("compute_copy"):
            buf = torch.empty(sum(lf.gnumel for lf in self.leaves),
                              dtype=dtype, device=dev)
        out = [v.view(lf.glocal) for v, lf in zip(
            torch.split(buf, [lf.gnumel for lf in self.leaves]),
            self.leaves)]
        if self.sharded:
            with category("accumulator_staging"):
                self._gather_sharded(shards, out, dtype, dev, counter)
        for i in self.replicated:
            out[i].copy_(shards[i])
        return out

    def _gather_sharded(self, shards, out, dtype, dev, counter) -> None:
        """The split leaves of :meth:`gather`'s ``out``: one flat
        ``all_gather_into_tensor`` over the data group."""
        import torch.distributed as dist
        n, world = self.n_sharded, self.rules.dp_size
        send = torch.empty(n, dtype=dtype, device=dev)
        for i in self.sharded:
            o, lf = self._off[i], self.leaves[i]
            send[o:o + lf.numel].view(lf.local).copy_(shards[i])
        recv = torch.empty(world * n, dtype=dtype, device=dev)
        dist.all_gather_into_tensor(recv, send, group=self.rules.dp_group)
        if counter is not None:
            counter.all_gathers += 1
            counter.words += recv.numel()
        del send
        for i in self.sharded:
            o, lf = self._off[i], self.leaves[i]
            step = lf.local[lf.data_dim]
            for q in range(world):
                out[i].narrow(lf.data_dim, q * step, step).copy_(
                    recv[q * n + o:q * n + o + lf.numel].view(lf.local))

    def reduce_scatter(self, grads, counter=None) -> list:
        """Gradients in the ``gather_fsdp`` layout (a tensor or None a
        leaf, one dtype) -> the split leaves' sums over the data group, in
        the sharded layout: one ``reduce_scatter_tensor`` of one flat
        buffer, slot q holding data rank q's shard of every split leaf
        (none when no leaf is split). Returns, a leaf each, a view of the
        received slot for a split leaf and the gradient as given for the
        others, which the caller sums over the data group by an
        all-reduce: every rank then holds the same bits of a replicated
        leaf, where a reduce-scatter sums each slot in its own order. Each
        split leaf's entry of ``grads`` (a list) is dropped once copied, so
        the caller's gradients go as the buffer fills."""
        out = list(grads)
        if not self.sharded:
            return out
        import torch.distributed as dist
        first = next(g for g in grads if g is not None)
        world, n = self.rules.dp_size, self.n_sharded
        with category("accumulator_staging"):
            send = torch.empty(world * n, dtype=first.dtype,
                               device=first.device)
        for i in self.sharded:
            g, o, lf = grads[i], self._off[i], self.leaves[i]
            step = lf.local[lf.data_dim]
            for q in range(world):
                dst = send[q * n + o:q * n + o + lf.numel].view(lf.local)
                if g is None:
                    dst.zero_()
                else:
                    dst.copy_(g.narrow(lf.data_dim, q * step, step))
            grads[i] = None
        with category("accumulator_staging"):
            recv = torch.empty(n, dtype=send.dtype, device=send.device)
            dist.reduce_scatter_tensor(recv, send, group=self.rules.dp_group)
        if counter is not None:
            counter.reduce_scatters += 1
            counter.words += send.numel()
        for i in self.sharded:
            o, lf = self._off[i], self.leaves[i]
            out[i] = recv[o:o + lf.numel].view(lf.local)
        return out

    def replicated_buffer(self, device, extra: int = 0):
        """A zeroed float32 buffer of the leaves replicated over the data
        axes (their compute-copy shape) and ``extra`` more slots, and its
        views a leaf (None for a split leaf): what one all-reduce over the
        data group sums."""
        sizes = [self.leaves[i].gnumel for i in self.replicated]
        with category("accumulator_staging"):
            buf = torch.zeros(self.n_replicated + extra,
                              dtype=torch.float32, device=device)
        views = [None] * len(self.leaves)
        for i, v in zip(self.replicated,
                        torch.split(buf[:sum(sizes)], sizes)):
            views[i] = v.view(self.leaves[i].glocal)
        return buf, views

    def full_leaf(self, i: int, shard, dst: int = 0):
        """Leaf ``i`` whole on rank ``dst`` of the rules' group (None on the
        others), from every rank's shard by one ``gather``; the shard
        itself without a group."""
        if self.rules.group is None:
            return shard
        import torch.distributed as dist
        lf, group = self.leaves[i], self.rules.group
        world = dist.get_world_size(group)
        mine = dist.get_rank(group) == dst
        pieces = [torch.empty_like(shard) for _ in range(world)] \
            if mine else None
        dist.gather(shard.contiguous(), pieces,
                    group_dst=dst, group=group)
        if not mine:
            return None
        full = torch.empty(lf.shape, dtype=shard.dtype, device=shard.device)
        for q, piece in enumerate(pieces):
            full[shard_slice(lf.shape, lf.spec, self.rules.mesh,
                             shard_coords(self.rules, q))] = piece
        return full

    def shard_bytes(self) -> int:
        """The bytes of this rank's float32 shards of every leaf."""
        return 4 * sum(lf.numel for lf in self.leaves)


class _Meta:
    """A stacked leaf's shape (and its stack depth) in the layout's
    :attr:`Layout.like` tree."""

    def __init__(self, shape, lead):
        self.shape, self.lead = tuple(shape), lead


def _meta_like(sub, lead):
    if isinstance(sub, dict):
        return {k: _meta_like(v, lead) for k, v in sub.items()}
    return _Meta(tuple(lead) + tuple(sub.shape), len(lead))



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
    """A spec tree for a decode cache from ``init_cache`` (or a paged
    pool's cache): each leaf by the name of the innermost dict key above
    it."""
    def walk(sub, name):
        if isinstance(sub, dict):
            return {k: walk(v, k) for k, v in sub.items()}
        if isinstance(sub, (list, tuple)):
            return type(sub)(walk(v, name) for v in sub)
        return _cache_leaf_spec(name, tuple(sub.shape), rules)
    return walk(cache, None)


@dataclasses.dataclass(frozen=True)
class CacheShard:
    """One rank's shard of a decode-cache leaf under :func:`cache_specs`:
    its shape here (``local``) and, for a K/V leaf (and its scales), its
    slice of the rows each row block holds, a slot row (B, S) or a page
    (num_pages, page_size): local row j of a block stands for position
    ``start + j`` of the block's ``stride`` positions. ``split``: the rows
    are split over the model axis (else every rank holds whole blocks,
    ``start`` 0 and ``stride`` the local rows)."""
    local: Tuple[int, ...]
    start: int
    stride: int
    split: bool


def cache_shard(name, shape, rules: Rules, coords=None) -> CacheShard:
    """The shard of the cache leaf ``name`` of ``shape`` on the rank at
    ``coords`` (default the rules' own), as :func:`shard_shape` gives a
    parameter's: the K/V rows (dim -3 of k/v, dim -2 of their scales) cut
    over the model axis where :func:`cache_specs` splits them."""
    shape = tuple(shape)
    spec = _cache_leaf_spec(name, shape, rules)
    coords = rules.coords if coords is None else coords
    local = shard_shape(shape, spec, rules.mesh)
    nd = len(shape)
    rdim = {"k": nd - 3, "v": nd - 3, "k_scale": nd - 2,
            "v_scale": nd - 2}.get(name)
    if rdim is None or rdim < 0:
        return CacheShard(local, 0, 0, False)
    cut = shard_slice(shape, spec, rules.mesh, coords)[rdim]
    return CacheShard(local, cut.start, shape[rdim],
                      local[rdim] != shape[rdim])

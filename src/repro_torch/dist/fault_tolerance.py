"""Fault-tolerant training: checkpoint-restore runner, failure injection,
straggler quorum admission, elastic remesh (the counterpart of
``repro.dist.fault_tolerance``, whose module imports JAX).

``TrainingRunner`` owns the training loop: it snapshots the state through
``repro_torch.checkpoint.Checkpointer`` every ``ckpt_every`` steps (async,
atomic commit) and, on an injected or real node failure, restores the
newest committed checkpoint, fast-forwards the data pipeline to the
restored step (the data factory is seeded by step index, so recovery is
deterministic: a crashed run and an uninterrupted one take the same
trajectory), rebuilds the step function — with ``elastic``, on the
largest mesh the surviving ranks fill (``dist.elastic.largest_mesh_shape``
over ``dist.elastic.remesh``'s group) — and resumes. A sharded state
(``layout``) is checkpointed as global leaves in one directory for the
job and restored into the layout of the mesh in force, so a lost rank's
shard comes back from disk. Restarts are budgeted; blowing the budget is an error, not a
hang. The JAX loop's observability is ported (``repro_torch.obs``): the
``repro_train_step_seconds`` histogram, the ``repro_train_ckpt_saves_total``
and ``repro_train_restarts_total`` counters, the ``train.restore``,
``train.ckpt_save`` and ``train.step`` spans, the ``train.restart`` instant,
and ``mark_dispatch("train.step")`` before each step, whose one metrics
fetch is the step's single host sync.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.checkpoint import Checkpointer
from repro_torch.dist.elastic import largest_mesh_shape, remesh
from repro_torch.dist.sharding import Mesh, make_rules
from repro_torch.tree import leaves, unflatten

_M_STEP_S = obs.histogram("repro_train_step_seconds",
                          "wall time per training step (dispatch + host "
                          "metric fetch)")
_M_CKPT = obs.counter("repro_train_ckpt_saves_total",
                      "checkpoint snapshots initiated")
_M_RESTARTS = obs.counter("repro_train_restarts_total",
                          "restore-and-resume cycles after node failures")


class NodeFailure(RuntimeError):
    """A (injected or detected) node failure: unwind to the restore path.
    ``survivors``: the ranks of the default group still up (None: all)."""

    def __init__(self, msg: str, survivors: Optional[Sequence[int]] = None):
        super().__init__(msg)
        self.survivors = survivors


class FailureSource:
    """Deterministic failure injection at global step indices.

    Each scheduled failure fires exactly once: after recovery the
    re-executed step succeeds, like a real transient node loss.
    """

    def __init__(self, fail_at: Iterable[int] = (),
                 survivors: Optional[Sequence[int]] = None):
        self._pending = set(int(s) for s in fail_at)
        self.survivors = survivors

    def maybe_fail(self, step: int) -> None:
        if step in self._pending:
            self._pending.discard(step)
            raise NodeFailure(f"injected node failure at step {step}",
                              self.survivors)


class DeadlineGate:
    """Straggler quorum admission (async-relaxation, arXiv:1712.06047 §4).

    Workers report arrival times for a sync point; the gate closes at
    ``deadline_s`` provided at least ``quorum`` (fraction) arrived, dropping
    stragglers from the collective. If the quorum itself is late, the gate
    stays open until the quorum-th arrival — correctness over latency.
    """

    def __init__(self, deadline_s: float, quorum: float = 0.75):
        if not 0.0 < quorum <= 1.0:
            raise ValueError(f"quorum must be in (0, 1], got {quorum}")
        self.deadline_s = float(deadline_s)
        self.quorum = float(quorum)

    def admit(self, arrivals: Sequence[float]) -> Tuple[List[int], float]:
        """-> (admitted worker indices, wall-clock wait before closing)."""
        n = len(arrivals)
        if n == 0:
            return [], 0.0
        need = max(int(math.ceil(self.quorum * n)), 1)
        within = [i for i, t in enumerate(arrivals) if t <= self.deadline_s]
        if len(within) >= need:
            if len(within) == n:  # everyone made it: close at last arrival
                return within, max(arrivals)
            return within, self.deadline_s
        # quorum missed the deadline: wait for the need-th arrival
        cutoff = sorted(arrivals)[need - 1]
        admitted = [i for i, t in enumerate(arrivals) if t <= cutoff]
        return admitted, cutoff


class TrainingRunner:
    """Checkpoint-restore training loop.

    step_builder(rules) -> step; step(state, batch) -> (state, metrics dict
    of device scalars). ``rules``: the ``dist.sharding.Rules`` the step is
    built for (bound to its process group), or None on one device.
    data_factory(start_step) -> batch iterator positioned at
    ``start_step`` (the deterministic fast-forward contract), closed by
    the runner when it has a ``close`` method. init_state() ->
    the initial state, used for a cold start and as the template a restore
    copies into. ``layout``: for a sharded state, rules ->
    ``dist.sharding.Layout`` of the state under them; the runner then
    calls ``init_state(rules)`` and checkpoints through the layout (one
    directory, rank 0 writing). With ``elastic``, a failure's survivors
    (``NodeFailure.survivors``) get a new group (``remesh``) on the
    largest mesh they fill with the model axis kept, new rules and a step
    built for them; a rank that is not among them leaves: :meth:`run`
    returns None and ``left`` is True.
    """

    def __init__(self, step_builder: Callable, rules, data_factory: Callable,
                 init_state: Callable, ckpt_dir, *, ckpt_every: int = 100,
                 keep: int = 3, failure_source: Optional[FailureSource] = None,
                 max_restarts: int = 10, elastic: bool = False,
                 layout: Optional[Callable] = None):
        self.step_builder = step_builder
        self.rules = rules
        self.data_factory = data_factory
        self.init_state = init_state
        self.ckpt = Checkpointer(ckpt_dir, keep=keep)
        self.ckpt_every = int(ckpt_every)
        self.failure_source = failure_source
        self.max_restarts = int(max_restarts)
        self.elastic = elastic
        self.layout = layout
        self._lay = None
        self.left = False
        self.restarts = 0
        self.metrics_log: List[dict] = []
        self.step: Optional[Callable] = None

    def _build(self) -> None:
        self.step = self.step_builder(self.rules)

    def _layout(self):
        """The state's layout under the rules in force (None: unsharded)."""
        if self.layout is None:
            return None
        if self._lay is None or self._lay[0] is not self.rules:
            self._lay = (self.rules, self.layout(self.rules))
        return self._lay[1]

    def _remesh(self, survivors) -> bool:
        """Shrink the rules' group to the first of ``survivors`` that fill
        ``largest_mesh_shape`` (the model axis kept); whether this rank is
        still in the job."""
        mesh = self.rules.mesh
        members = dist.get_process_group_ranks(self.rules.group)
        alive = sorted(members if survivors is None else survivors)
        tp = self.rules.tp_size
        data, model = largest_mesh_shape(len(alive), tp)
        group = remesh(self.rules.group, alive[:data * model])
        if group is self.rules.group:
            return True
        if group == dist.GroupMember.NON_GROUP_MEMBER:
            return False
        shape = (Mesh(("data", "model"), (data, model))
                 if "model" in mesh.axis_names
                 else Mesh(("data",), (data,)))
        self.rules = make_rules(shape, group)
        return True

    def _init_or_restore(self, state=None):
        """(state, first step): a fresh state, or the newest checkpoint
        copied into a template: ``state`` (a fresh one when None); for a
        sharded state, empty shards of the layout in force, shaped as
        ``state``'s tree."""
        lay = self._layout()
        fresh = (self.init_state if lay is None else
                 lambda: self.init_state(self.rules))
        if self.ckpt.latest_step() is None:
            return fresh(), 0
        if state is None:
            template = fresh()
        elif lay is None:
            template = state
        else:
            dev = leaves(state)[0].device
            shapes = [lf.local for lf in lay.leaves]
            template = unflatten(state, [
                torch.empty(s, dtype=t.dtype, device=dev) for s, t in
                zip(shapes + [()] + shapes + shapes, leaves(state))])
        state, step, _ = self.ckpt.restore(template, layout=lay)
        return state, step

    def run(self, total_steps: int):
        """Train to ``total_steps``, surviving failures; returns the final
        state (None on a rank an elastic remesh left out). A final
        checkpoint is committed at ``total_steps`` so a follow-on job
        resumes exactly where this one stopped."""
        self._build()
        state, start = self._init_or_restore()
        while True:
            try:
                state = self._loop(state, start, total_steps)
                if start < total_steps:
                    # not when the restored step is already at the target
                    # (a shorter re-run against an old directory): that
                    # would overwrite a genuine checkpoint with later state
                    self.ckpt.save(total_steps, state, blocking=True,
                                   layout=self._layout())
                return state
            except NodeFailure as failure:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"restart budget exhausted: {self.restarts - 1} "
                        f"restarts allowed, training keeps failing")
                self.ckpt.wait()  # let an in-flight snapshot commit
                if (self.elastic and self.rules is not None
                        and self.rules.group is not None
                        and not self._remesh(failure.survivors)):
                    self.left = True
                    return None
                with obs.span("train.restore", restart=self.restarts):
                    self._build()
                    state, start = self._init_or_restore(state)
                _M_RESTARTS.inc()
                obs.instant("train.restart", restart=self.restarts,
                            resume_step=start)
                # drop the entries of steps that run again, so the log
                # reads as one uninterrupted trajectory
                self.metrics_log = [m for m in self.metrics_log
                                    if m["step"] < start]

    def _loop(self, state, start: int, total_steps: int):
        data = self.data_factory(start)
        timed = obs.enabled()
        try:
            for step in range(start, total_steps):
                if step % self.ckpt_every == 0:
                    # snapshot BEFORE the step: the manifest's step is the
                    # first to run again on restore
                    with obs.span("train.ckpt_save", step=step):
                        self.ckpt.save(step, state, layout=self._layout())
                    _M_CKPT.inc()
                if self.failure_source is not None:
                    self.failure_source.maybe_fail(step)
                batch = next(data)
                t0 = time.perf_counter() if timed else 0.0
                obs.mark_dispatch("train.step")
                with obs.span("train.step", step=step):
                    state, metrics = self.step(state, batch)
                    # one host fetch per step, for all the metrics
                    names = sorted(metrics)
                    values = torch.stack(
                        [metrics[k].detach().float().reshape(())
                         for k in names]).tolist()
                if timed:
                    _M_STEP_S.observe(time.perf_counter() - t0)
                rec = {"step": step}
                rec.update(zip(names, values))
                self.metrics_log.append(rec)
        finally:
            close = getattr(data, "close", None)
            if close is not None:
                close()
        return state

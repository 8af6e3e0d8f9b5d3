"""Async, atomic checkpointing (the counterpart of
``repro.checkpoint.checkpointer``, with the same layout):

  <dir>/step_<N>/
          manifest.json     leaf count, shapes, dtypes, step, extra state
          arrays/<idx>.npy  one file per tensor leaf

Writes go to step_<N>.tmp, are fsynced and then renamed: a crashed writer
never corrupts the latest checkpoint (restore picks the newest committed
step). Saves run on a background thread; ``save`` blocks only while an
earlier save is still being written. The newest ``keep`` checkpoints are
kept. Types numpy has no name for (bfloat16) are stored as raw bytes and
viewed back on restore.

Leaves are the tensors of a tree of dicts (in sorted key order), lists,
tuples and NamedTuples, in a fixed order. Unlike the JAX version,
:meth:`Checkpointer.restore` copies into the tensors of the template it is
given and returns them: at full width a second training state would not
fit beside the first.

A sharded training state (``layout``: a ``dist.sharding.Layout``; the
state a ``TrainState`` in it) is stored as JAX's checkpointer stores one:
global leaves, one file a leaf, in one directory for the job. The save is
collective: each leaf is gathered whole to rank 0 of the layout's group
(``Layout.full_leaf``) and written before the next, so rank 0's host holds
one leaf at a time, and every rank waits for the commit. A restore reads
each leaf's file (memory-mapped) and copies out the shard the rules in
force give this rank, whatever mesh wrote it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.tree import leaves

#: torch dtypes by the names the manifest stores (numpy's, as in JAX)
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16,
           "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
           "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _flatten(tree) -> List[torch.Tensor]:
    out = leaves(tree)
    for t in out:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"checkpoint leaves must be tensors, got "
                            f"{type(t).__name__}")
    return out


def _write(path: Path, t: torch.Tensor) -> None:
    arr = (t.reshape(-1).view(torch.uint8).numpy()
           if t.dtype == torch.bfloat16 else t.numpy())
    with open(path, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())


def _state_leaves(tree, layout) -> list:
    """The layout's leaf index of each leaf of a ``TrainState`` in
    ``layout`` (params, step, m, v), None for the step."""
    n = len(layout.leaves)
    idx = list(range(n)) + [None] + list(range(n)) + list(range(n))
    if len(_flatten(tree)) != len(idx):
        raise ValueError(f"a sharded checkpoint holds a TrainState of "
                         f"{len(idx)} leaves, got {len(_flatten(tree))}")
    return idx


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Checkpointer:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = False, layout=None) -> None:
        """Snapshot ``tree`` at ``step``. Every tensor is copied to the host
        before the background write starts (a host tensor too, into fresh
        storage), so the caller may update the state in place right
        after. With ``layout`` the save is collective and blocking (see
        the module docstring)."""
        self.wait()
        if layout is not None and layout.rules.group is not None:
            self._save_sharded(step, tree, extra, layout)
            return
        host = [t.detach().to("cpu", copy=True,
                              memory_format=torch.contiguous_format)
                for t in _flatten(tree)]
        manifest = dict(step=int(step), n_leaves=len(host),
                        shapes=[list(t.shape) for t in host],
                        dtypes=[_NAMES[t.dtype] for t in host],
                        extra=extra or {})

        def write() -> None:
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            (tmp / "arrays").mkdir(parents=True)
            for i, t in enumerate(host):
                _write(tmp / "arrays" / f"{i}.npy", t)
            self._commit(tmp, final, manifest)

        def write_bg() -> None:
            # a failed snapshot surfaces at the next wait() or save(), not
            # with the thread
            try:
                write()
            except BaseException as e:   # re-raised by wait()
                self._error = e

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write_bg, daemon=True)
            self._thread.start()

    def _save_sharded(self, step, tree, extra, layout) -> None:
        import torch.distributed as dist
        group = layout.rules.group
        mine = dist.get_rank(group) == 0
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if mine:
            if tmp.exists():
                shutil.rmtree(tmp)
            (tmp / "arrays").mkdir(parents=True)
        shapes, dtypes = [], []
        for i, (t, li) in enumerate(zip(_flatten(tree),
                                        _state_leaves(tree, layout))):
            full = t if li is None else layout.full_leaf(li, t.detach())
            if mine:
                host = full.detach().to("cpu", copy=True,
                                        memory_format=torch.contiguous_format)
                shapes.append(list(host.shape))
                dtypes.append(_NAMES[host.dtype])
                _write(tmp / "arrays" / f"{i}.npy", host)
            del full
        if mine:
            manifest = dict(step=int(step), n_leaves=len(shapes),
                            shapes=shapes, dtypes=dtypes, extra=extra or {})
            self._commit(tmp, final, manifest)
        dist.barrier(group=group)

    def _commit(self, tmp: Path, final: Path, manifest: dict) -> None:
        """Write the manifest, fsync, and rename ``tmp`` to ``final``."""
        with open(tmp / "manifest.json", "w") as f:
            f.write(json.dumps(manifest))
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp / "arrays")
        _fsync_dir(tmp)
        if final.exists():
            shutil.rmtree(final)                  # re-save of the same step
        os.replace(tmp, final)                    # atomic commit
        _fsync_dir(self.dir)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in sorted(self.steps())[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if not p.name.endswith(".tmp")]

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return max(steps) if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                layout=None):
        """Copy checkpoint ``step`` (default the newest) into the tensors of
        ``template``, which has the saved tree's structure, shapes and
        dtypes. With ``layout`` the template is this rank's shard of a
        ``TrainState`` in it, and each leaf's shard is cut from the global
        leaf. Returns (template, step, extra)."""
        if layout is not None:
            return self._restore_sharded(template, step, layout)
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        targets = _flatten(template)
        if manifest["n_leaves"] != len(targets):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, template has "
                f"{len(targets)}: architecture mismatch")
        for i, (t, shape, dtype) in enumerate(zip(
                targets, manifest["shapes"], manifest["dtypes"])):
            if list(t.shape) != shape or _NAMES[t.dtype] != dtype:
                raise ValueError(f"leaf {i}: checkpoint {dtype}{shape}, "
                                 f"template {_NAMES[t.dtype]}"
                                 f"{list(t.shape)}")
        with torch.no_grad():
            for i, (t, shape, dtype) in enumerate(zip(
                    targets, manifest["shapes"], manifest["dtypes"])):
                a = torch.from_numpy(np.load(d / "arrays" / f"{i}.npy"))
                if dtype == "bfloat16":
                    a = a.view(torch.bfloat16).reshape(shape)
                t.copy_(a)
        return template, manifest["step"], manifest.get("extra", {})

    def _restore_sharded(self, template, step, layout):
        from repro_torch.dist.sharding import shard_shape, shard_slice
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        targets = _flatten(template)
        idx = _state_leaves(template, layout)
        if manifest["n_leaves"] != len(targets):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, template has "
                f"{len(targets)}: architecture mismatch")
        mesh, coords = layout.rules.mesh, layout.rules.coords
        cuts = []
        for i, (t, li, shape, dtype) in enumerate(zip(
                targets, idx, manifest["shapes"], manifest["dtypes"])):
            spec = () if li is None else layout.leaves[li].spec
            want = shard_shape(shape, spec, mesh)
            if list(t.shape) != list(want) or _NAMES[t.dtype] != dtype:
                raise ValueError(f"leaf {i}: checkpoint {dtype}{shape} cut "
                                 f"to {list(want)}, template "
                                 f"{_NAMES[t.dtype]}{list(t.shape)}")
            cuts.append(shard_slice(shape, spec, mesh, coords))
        with torch.no_grad():
            for i, (t, shape, dtype, cut) in enumerate(zip(
                    targets, manifest["shapes"], manifest["dtypes"], cuts)):
                a = np.load(d / "arrays" / f"{i}.npy", mmap_mode="r")
                if dtype == "bfloat16":
                    a = a.view(np.uint16)
                a = np.array(a.reshape(shape)[cut])
                src = torch.from_numpy(a)
                if dtype == "bfloat16":
                    src = src.view(torch.bfloat16)
                t.copy_(src)
        return template, manifest["step"], manifest.get("extra", {})

"""Checkpointing with atomic publish and async writes (the port of
``repro.train.checkpoint``).

Layout, the reference's:  <dir>/step_<N>/
                              manifest.json   step, structure, leaf inventory
                              <leaf_id>.npy   one file a leaf (full array)
                          <dir>/LATEST        the newest published step

* **leaf ids** are the reference's: the key path of each leaf in jax's
  ``keystr`` spelling (``.params['layers']['attn']['wq']``) with quotes
  and brackets dropped and dots made underscores
  (``leaf__params_layers_attn_wq``), over the same flattening order
  (dataclass fields in order, dict keys sorted, lists in order).  With
  the reference's tree (``"layers"`` stacked, as ``StackedLM.tree``
  gives it) a checkpoint written by either package restores in the
  other, leaf for leaf;
* **atomic publish**: the leaves and the manifest go to ``step_<N>.tmp``,
  fsynced, and the directory is renamed into place; a crash mid-save
  never corrupts a published step, and ``steps`` skips partial ones;
* **async**: ``save(..., blocking=False)`` copies every leaf to host
  memory first (a copy, so later in-place updates of the state do not
  reach the snapshot), then writes on a daemon thread; the next save
  joins the previous one.  ``keep`` bounds the published steps.

bf16 leaves are written as the reference writes them (numpy has no
bf16: two raw bytes an element, ``"dtype": "bfloat16"`` in the
manifest) and read back through the manifest's dtype.  The reference's
own restore cannot read such a leaf back (``jax.device_put`` refuses the
raw dtype); the port's can.

``restore`` is template-driven, as the reference's: the template gives
the tree, the leaf ids and each leaf's device; the arrays keep the
dtype they were saved with.  The manifest's ``treedef`` is a description
of the structure for tools; neither package reads it.

**On a mesh** (ZeRO: each leaf this rank's shard) every rank calls
``save(..., shardings=)`` and ``restore(..., shardings=)`` with a tree
of ``sharding.layout.Sharding`` (or None) leaves.  ``save`` gathers each
sharded leaf to its full array on rank 0's host (``gather_to_host``), a
collective, on the calling thread before any write starts; rank 0 alone
writes (the ranks share the directory), and the others wait for its
files at a barrier in ``wait`` (the next save's first step, or before a
blocking save returns).  The
files hold the full arrays, as on one device, so a checkpoint crosses
topologies: ``restore`` places each leaf with its ``Sharding`` on the
current mesh, any mesh, or on one device without shardings, and the
reference's manager reads it too.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import threading
import warnings
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..sharding.layout import Sharding, gather_to_host

Tree = Any


def _children(tree) -> list[tuple[str, Any]] | None:
    """(keystr part, child) pairs of a tree node in jax's flattening
    order, or None for a leaf (a ``Sharding`` is one)."""
    if isinstance(tree, Sharding):
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _flatten(tree: Tree, path: str = "") -> list[tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    return [x for part, child in kids for x in _flatten(child, path + part)]


def leaf_ids(tree: Tree) -> list[str]:
    """The reference's file id of every leaf, in flattening order."""
    return ["leaf_" + p.replace("'", "").replace("[", "_").replace("]", "")
            .replace(".", "_") for p, _ in _flatten(tree)]


def _rebuild(template: Tree, it) -> Tree:
    """``template``'s structure over leaves taken from ``it`` in
    flattening order."""
    if dataclasses.is_dataclass(template) and not isinstance(template,
                                                             type):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), it)
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        vals = {k: _rebuild(template[k], it) for k in sorted(template)}
        return {k: vals[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, it) for v in template)
    return next(it)


def _structure(tree: Tree) -> str:
    kids = _children(tree)
    if kids is None:
        return "*"
    inner = ", ".join(f"{part}: {_structure(child)}" for part, child in kids)
    return f"{type(tree).__name__}({inner})"


def _host(x, copy: bool = True) -> np.ndarray:
    """A host copy of a leaf as numpy (the leaf itself if it is a host
    tensor of its own and ``copy`` is False); bf16 as two raw bytes an
    element."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=copy)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.dtype("V2"))
        return x.numpy()
    return np.array(x, copy=True)


def _dtype_name(x, a: np.ndarray) -> str:
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(a.dtype)


def _load(path: pathlib.Path, dtype: str, lazy: bool = False
          ) -> torch.Tensor:
    """A leaf's array; ``lazy`` maps the file instead of reading it (the
    caller copies the block it needs, so a rank reads its shard only)."""
    a = np.load(path, mmap_mode="r" if lazy else None)
    if dtype == "bfloat16":
        a = a.view(np.int16)
        a = a if lazy else a.copy()
    with warnings.catch_warnings():
        # a read-only map is never written: ``Sharding.place`` copies
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._barrier = False       # a sharded save's ranks meet in wait()

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Tree, *, blocking: bool = True,
             shardings: Tree | None = None):
        """Snapshot every leaf to host memory and persist it; returns at
        once if ``blocking`` is False (the write runs on a thread).  With
        ``shardings`` every rank calls it (module docstring)."""
        self.wait()
        flat = _flatten(tree)
        ids = leaf_ids(tree)
        if shardings is None:
            writer = True
            host = [_host(x) for _, x in flat]
        else:
            sh = _shardings(shardings, len(flat))
            writer = dist.get_rank() == 0
            host = []
            for (_, x), s in zip(flat, sh):
                if s is None:
                    if writer:
                        host.append(_host(x))
                    continue
                full = gather_to_host(x, s)
                if writer:
                    host.append(_host(full, copy=False))
                del full
            self._barrier = True
        if not writer:
            if blocking:
                self.wait()
            return
        manifest = {
            "step": int(step),
            "treedef": _structure(tree),
            "leaves": [{"id": i, "shape": list(a.shape),
                        "dtype": _dtype_name(x, a)}
                       for i, a, (_, x) in zip(ids, host, flat)],
        }

        def write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for i, a in zip(ids, host):
                with open(tmp / f"{i}.npy", "wb") as f:
                    np.save(f, a)
                    f.flush()
                    os.fsync(f.fileno())
            with open(tmp / "manifest.json", "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            with open(self.dir / "LATEST", "w") as f:
                f.write(str(step))
                f.flush()
                os.fsync(f.fileno())
            self._gc()

        if blocking:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        """Join the pending write; after a sharded save, every rank waits
        here until rank 0's files are published (a collective then)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _gc(self):
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def steps(self) -> list[int]:
        """Published steps (a ``.tmp`` directory or one without a
        manifest is skipped), oldest first."""
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: Tree, *, step: int | None = None,
                shardings: Tree | None = None) -> tuple[Tree, int]:
        """-> (the tree of ``template``'s structure with the saved arrays,
        each on its template leaf's device (the CPU for a leaf that is not
        a tensor), step).  ``shardings`` (``template``'s structure, a
        ``Sharding`` or None a leaf) places each sharded leaf's block on
        this rank (``Sharding.place``): elastic across topologies."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        ids = leaf_ids(template)
        saved = [e["id"] for e in manifest["leaves"]]
        if ids != saved:
            raise ValueError(f"tree structure changed: the template's leaves "
                             f"{ids} differ from step {step}'s {saved}")
        flat = _flatten(template)
        sh = (_shardings(shardings, len(flat)) if shardings is not None
              else [None] * len(flat))
        out = []
        for (_, like), e, s in zip(flat, manifest["leaves"], sh):
            t = _load(d / f"{e['id']}.npy", e["dtype"], lazy=s is not None)
            dev = like.device if isinstance(like, torch.Tensor) else None
            if s is not None:
                t = s.place(t, device=dev)
            elif dev is not None:
                t = t.to(dev)
            out.append(t)
        return _rebuild(template, iter(out)), step


def _shardings(shardings: Tree, n: int) -> list:
    """The ``Sharding`` (or None) leaves of a shardings tree, checked
    against the ``n`` leaves of the tree they lay out."""
    sh = [s for _, s in _flatten(shardings)]
    if len(sh) != n:
        raise ValueError(f"{len(sh)} shardings for a tree of {n} leaves")
    return sh

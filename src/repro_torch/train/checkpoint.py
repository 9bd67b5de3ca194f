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
of the structure for tools; neither package reads it.  Shardings (the
reference's elastic restore onto a mesh) are a mesh leg and raise.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import threading
from typing import Any

import numpy as np
import torch

from .step import MESH_LEG

Tree = Any


def _children(tree) -> list[tuple[str, Any]] | None:
    """(keystr part, child) pairs of a tree node in jax's flattening
    order, or None for a leaf."""
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


def _host(x) -> np.ndarray:
    """A host copy of a leaf as numpy; bf16 as two raw bytes an element."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.dtype("V2"))
        return x.numpy()
    return np.array(x, copy=True)


def _dtype_name(x, a: np.ndarray) -> str:
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(a.dtype)


def _load(path: pathlib.Path, dtype: str) -> torch.Tensor:
    a = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Tree, *, blocking: bool = True):
        """Snapshot every leaf to host memory and persist it; returns at
        once if ``blocking`` is False (the write runs on a thread)."""
        self.wait()
        flat = _flatten(tree)
        ids = leaf_ids(tree)
        host = [_host(x) for _, x in flat]
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
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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
        a tensor), step)."""
        if shardings is not None:
            raise NotImplementedError(MESH_LEG)
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
        out = []
        for (_, like), e in zip(_flatten(template), manifest["leaves"]):
            t = _load(d / f"{e['id']}.npy", e["dtype"])
            out.append(t.to(like.device) if isinstance(like, torch.Tensor)
                       else t)
        return _rebuild(template, iter(out)), step

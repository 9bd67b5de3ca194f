"""What a step costs one rank, counted while it runs on the ``meta``
device: the port's counterpart of the accounting in
``repro.launch.hlo`` (not of its HLO parsing, which has no PyTorch
meaning).  ``launch.dryrun`` reads it.

``Census`` is a ``TorchDispatchMode``.  Within it, every aten op that
runs adds to four counts:

* ``flops`` — dot FLOPs: ``mm``, ``bmm``, ``addmm`` and ``baddbmm``
  (the einsums and linears lower to them), 2 M N K each by
  ``torch.utils.flop_counter``'s formulas, counted every time the op
  runs (the reference's trip-count weighting is built in: a layer loop
  is a Python loop);
* ``bytes`` — the operand and output bytes of each op that is not a
  view, an allocation or a collective: eager PyTorch runs each op as a
  kernel, so this is the reference's kernel-boundary HBM-traffic model
  as it stands;
* ``live`` / ``peak`` — the bytes of the storages that ops made within
  the census and that are still alive (each added when it is made and
  taken away when it dies, through a weak reference to its
  ``untyped_storage()``), and the largest value of that over the run.
  Storages that existed before (the step's arguments) count nothing,
  nor does an op that writes into them in place.

The collectives are counted by ``sharding.layout``'s
``record_traffic``, whose ``Traffic.ops`` lists one ``CollectiveOp`` a
call: ``collective_summary`` sums their ring link bytes by kind, with the
reference's kind names and factors (``hlo.py:60-74``):

    all-gather       (P-1)/P * output_bytes
    reduce-scatter   (P-1)/P * input_bytes
    all-reduce       2 (P-1)/P * input_bytes      (RS + AG)
    all-to-all       (P-1)/P * input_bytes
    collective-permute     input_bytes
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective call as a rank sees it: the reference's
    ``CollectiveOp`` with the mesh axis in place of the HLO line."""
    kind: str
    out_bytes: int
    in_bytes: int
    group_size: int
    axis: str = ""

    @property
    def link_bytes(self) -> float:
        """Per-rank bytes over the interconnect (ring algorithm)."""
        p = max(self.group_size, 1)
        frac = (p - 1) / p
        if self.kind == "all-gather":
            return frac * self.out_bytes
        if self.kind == "reduce-scatter":
            return frac * self.in_bytes
        if self.kind == "all-reduce":
            return 2.0 * frac * self.in_bytes
        if self.kind == "all-to-all":
            return frac * self.in_bytes
        return float(self.in_bytes)      # collective-permute


def collective_summary(ops) -> dict:
    """``{"total_link_bytes", "by_kind": {kind: {"count", "bytes"}}}``
    of a list of ``CollectiveOp`` (the reference's
    ``collective_summary``)."""
    by_kind: dict[str, dict] = defaultdict(lambda: dict(count=0, bytes=0.0))
    for op in ops:
        by_kind[op.kind]["count"] += 1
        by_kind[op.kind]["bytes"] += op.link_bytes
    total = sum(v["bytes"] for v in by_kind.values())
    return {"total_link_bytes": total, "by_kind": dict(by_kind)}


_DOTS = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
         torch.ops.aten.baddbmm)
_ALLOCS = (torch.ops.aten.empty, torch.ops.aten.empty_strided,
           torch.ops.aten.empty_like, torch.ops.aten.new_empty,
           torch.ops.aten.new_empty_strided)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Census(TorchDispatchMode):
    """Counts ``flops``, ``bytes``, ``live`` and ``peak`` (module
    docstring) of the ops run within it."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = {op: flop_registry[op] for op in _DOTS}
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen: dict[int, int] = {}     # id(storage) -> bytes counted

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key)

    def _storage(self, t: torch.Tensor, new: bool) -> None:
        """Mark ``t``'s storage seen; one first seen as an op's output
        (``new``) is counted live until it dies."""
        s = t.untyped_storage()
        key = id(s)
        if key in self._seen:
            return
        n = s.nbytes() if new else 0
        self._seen[key] = n
        weakref.finalize(s, self._free, key)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        for t in ins:
            self._storage(t, False)
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        packet = func._overloadpacket
        if packet in self._formulas:
            self.flops += int(self._formulas[packet](*args, **kwargs,
                                                     out_val=out))
        if (func.namespace == "aten" and not func.is_view
                and packet not in _ALLOCS):
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self._storage(t, True)
        return out

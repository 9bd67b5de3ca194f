"""Tensor layouts on a mesh, and the collectives that move a tensor
between them: the port's counterpart of ``jax.sharding.NamedSharding``
and of the collectives that GSPMD inserts for it.

A ``Sharding`` is a mesh and a spec, one entry per tensor dim: ``None``
(the dim is whole on every rank), a mesh axis name, or a tuple of names
(the dim split over those axes, the first one major), the entries of the
reference's ``PartitionSpec``.  A sharded tensor lives as each rank's
local shard, a plain tensor; the ``Sharding`` says which block of the
full tensor that is (``bounds``) and gives the ``torch.distributed.tensor``
placements of that layout (``placements``), the port's sharding metadata.
The rule tables (``rules.py``) only ever split a dim evenly (the
divisibility fallback of ``models.base.ShardCtx.spec``), so every shard of
a tensor has the same shape.

The collectives are explicit calls on local shards over the mesh's
per-axis process groups (``DeviceMesh.get_group``):

* ``gather``       — the full tensor from the local shards (all-gather
  along each sharded dim);
* ``reduce_shard`` — this rank's shard of the sum, over some mesh axes, of
  a full tensor that each rank holds (reduce-scatter along the dims those
  axes shard, an all-reduce over those that shard nothing, a local slice
  for the other axes): what GSPMD does to a gradient constrained to a
  sharding;
* ``gather_to_host`` — the full tensor on one rank's host, from every
  rank's shard (one gather of host copies: what a checkpoint writer
  needs, without the full tensor on every rank and card);
* ``gather_scalar`` — one scalar from every rank of the mesh, in the
  mesh's shape, the same bits on every rank: each rank then sums them in
  the same order, so a norm or a mean that must be equal everywhere is
  equal bit for bit.

The tensor-parallel model code (``models/attention.py``, ``ffn.py``,
``transformer.py``) moves its activations with three collectives over
one mesh axis that autograd differentiates, each backward the other's
transpose:

* ``all_gather_axis``     — concatenate the group's tensors along a dim;
  its backward is a reduce-scatter along that dim;
* ``reduce_scatter_axis`` — this rank's 1/n along a dim of the group's
  sum; its backward is an all-gather;
* ``all_reduce_axis``     — the group's sum; its backward is itself.

Read so, a tensor that every rank of the group holds in full stands for
the SUM of the ranks' tensors in the backward: the loss a tensor-parallel
model returns is the same on every rank of the model axis, and its
backward is seeded with ``1 / model`` on each (``train.step``).

Within a ``record_traffic()`` block, every collective of this module
adds the bytes a rank sends over each mesh axis to the yielded
``Traffic`` (``bytes`` by axis; ``calls`` lists each call's operation,
axis and tensor shape); outside one it counts nothing.  A ring
collective over n ranks of a tensor of b bytes (the all-gather's local
input, the reduce-scatter's and the all-reduce's full input) counts (n -
1) b, (n - 1) b / n and 2 (n - 1) b / n; a collective over the whole
world (``gather_to_host``, ``gather_scalar``) counts under ``"world"``.

``gloo`` carries all of them on CPU and CUDA tensors alike (it stages a
CUDA tensor through the host itself), so the ranks of a world may share
one card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Any

import torch
import torch.distributed as dist

from ..launch.mesh import axis_sizes


def entry_names(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A layout of a tensor on ``mesh`` (a ``DeviceMesh``, or any object
    that ``launch.mesh.axis_sizes`` reads): ``spec`` has one entry a
    tensor dim."""
    mesh: Any
    spec: tuple

    @property
    def sizes(self) -> dict[str, int]:
        return axis_sizes(self.mesh)

    @property
    def placements(self) -> tuple:
        """One DTensor placement a mesh dim, in mesh order: ``Shard(d)``
        where tensor dim ``d``'s entry names that axis, ``Replicate()``
        otherwise.  A dim split over two axes is ``Shard(d)`` on both,
        nested in mesh order (the rule tables list such axes in mesh
        order)."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for axis in self.sizes:
            dims = [d for d, e in enumerate(self.spec)
                    if axis in entry_names(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    @property
    def replicated_axes(self) -> tuple[str, ...]:
        """The mesh axes that no dim is split over: the ranks along them
        hold the same shard."""
        used = {a for e in self.spec for a in entry_names(e)}
        return tuple(a for a in self.sizes if a not in used)

    def shard_shape(self, shape) -> tuple[int, ...]:
        sizes = self.sizes
        return tuple(n // math.prod(sizes[a] for a in entry_names(e))
                     for n, e in zip(shape, self.spec))

    def full_shape(self, local_shape) -> tuple[int, ...]:
        sizes = self.sizes
        return tuple(n * math.prod(sizes[a] for a in entry_names(e))
                     for n, e in zip(local_shape, self.spec))

    def coordinate(self, coord=None) -> dict[str, int]:
        """Axis name -> this rank's index on it (``DeviceMesh
        .get_coordinate``), or that of ``coord`` (a tuple in mesh
        order)."""
        if coord is None:
            coord = self.mesh.get_coordinate()
            if coord is None:
                raise ValueError("this rank is not in the mesh")
        return dict(zip(self.sizes, (int(c) for c in coord)))

    def bounds(self, shape, coord=None) -> tuple[tuple[int, int], ...]:
        """The [start, stop) of each dim of the block of a ``shape`` tensor
        that the rank at ``coord`` (default: this rank) holds."""
        sizes, at = self.sizes, self.coordinate(coord)
        out = []
        for n, e in zip(shape, self.spec):
            lo, size = 0, n
            for a in entry_names(e):
                size //= sizes[a]
                lo += at[a] * size
            out.append((lo, lo + size))
        return tuple(out)

    def local(self, t: torch.Tensor, coord=None) -> torch.Tensor:
        """The block of the full tensor ``t`` at ``coord``: a view."""
        for d, (lo, hi) in enumerate(self.bounds(t.shape, coord)):
            if hi - lo != t.shape[d]:
                t = t.narrow(d, lo, hi - lo)
        return t

    def place(self, t: torch.Tensor, *, device=None,
              coord=None) -> torch.Tensor:
        """The counterpart of ``jax.device_put(x, sharding)``: this rank's
        shard of the full tensor ``t``, a contiguous copy on ``device``
        (default ``t``'s); ``t`` itself is not kept."""
        block = self.local(t, coord)
        out = torch.empty(block.shape, dtype=block.dtype,
                          device=t.device if device is None else device)
        return out.copy_(block)


def _group(mesh, axis: str):
    return mesh.get_group(axis)


@dataclasses.dataclass(eq=False)
class Traffic:
    """What this rank's collectives sent within one ``record_traffic``
    block: bytes by mesh axis (``"world"`` for the whole-world
    collectives), and (operation, axis, shape of the tensor counted) of
    each call in call order."""
    bytes: dict[str, float] = dataclasses.field(default_factory=dict)
    calls: list[tuple[str, str, tuple[int, ...]]] = dataclasses.field(
        default_factory=list)


_OPEN: list[Traffic] = []


@contextlib.contextmanager
def record_traffic():
    """Within the block, each collective is added to the yielded
    ``Traffic`` (and to any enclosing block's)."""
    record = Traffic()
    _OPEN.append(record)
    try:
        yield record
    finally:
        _OPEN.remove(record)


def _count(op: str, axis: str, t: torch.Tensor, factor: float) -> None:
    """Add ``factor`` x ``t``'s bytes to ``axis``'s count of each open
    record, and the call to its list."""
    if not _OPEN:
        return
    b = factor * t.numel() * t.element_size()
    for record in _OPEN:
        record.bytes[axis] = record.bytes.get(axis, 0.0) + b
        record.calls.append((op, axis, tuple(t.shape)))


def all_gather_dim(t: torch.Tensor, mesh, axis: str, n: int,
                   dim: int) -> torch.Tensor:
    """``t`` from every rank of ``axis``'s group, concatenated along
    ``dim`` in the group's order."""
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count("all_gather", axis, t, n - 1)
    dist.all_gather_into_tensor(out, x, group=_group(mesh, axis))
    return out.movedim(0, dim)


def _reduce_scatter_dim(t: torch.Tensor, mesh, axis: str, n: int,
                        dim: int) -> torch.Tensor:
    """The sum of ``t`` over ``axis``'s group, this rank's 1/n of it
    along ``dim``."""
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count("reduce_scatter", axis, t, (n - 1) / n)
    dist.reduce_scatter_tensor(out, x, group=_group(mesh, axis))
    return out.movedim(0, dim)


def _all_reduce(t: torch.Tensor, mesh, axis: str, n: int,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over ``axis``'s group (contiguous)."""
    _count("all_reduce", axis, t, 2 * (n - 1) / n)
    dist.all_reduce(t, op=op, group=_group(mesh, axis))
    return t


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, n, dim):
        ctx.args = (mesh, axis, n, dim)
        return all_gather_dim(t, mesh, axis, n, dim)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter_dim(g, *ctx.args),) + (None,) * 4


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, n, dim):
        ctx.args = (mesh, axis, n, dim)
        return _reduce_scatter_dim(t, mesh, axis, n, dim)

    @staticmethod
    def backward(ctx, g):
        return (all_gather_dim(g, *ctx.args),) + (None,) * 4


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, n):
        ctx.args = (mesh, axis, n)
        return _all_reduce(t.contiguous().clone(), mesh, axis, n)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g.contiguous().clone(), *ctx.args),) + \
            (None,) * 3


def all_gather_axis(t: torch.Tensor, mesh, axis: str,
                    dim: int) -> torch.Tensor:
    """The group of ``axis``'s tensors concatenated along ``dim`` in the
    group's order; the backward reduce-scatters along ``dim``.  ``t``
    itself on an axis of one rank.  A collective over ``axis``."""
    n = axis_sizes(mesh).get(axis, 1)
    return t if n == 1 else _AllGather.apply(t, mesh, axis, n, dim)


def reduce_scatter_axis(t: torch.Tensor, mesh, axis: str,
                        dim: int) -> torch.Tensor:
    """This rank's 1/n along ``dim`` of the sum of the group of
    ``axis``'s tensors; the backward all-gathers.  A collective over
    ``axis``."""
    n = axis_sizes(mesh).get(axis, 1)
    return t if n == 1 else _ReduceScatter.apply(t, mesh, axis, n, dim)


def all_reduce_axis(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``t`` over the group of each mesh axis in ``axes`` (a
    name or a tuple of names), a new tensor; the backward is the same
    sum.  A collective over those axes."""
    sizes = axis_sizes(mesh)
    for a in entry_names(axes):
        if sizes.get(a, 1) > 1:
            t = _AllReduce.apply(t, mesh, a, sizes[a])
    return t


def all_reduce_max(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise max of ``t`` over ``axis``'s group, a new tensor
    outside autograd (a softmax's shift, whose gradient cancels)."""
    n = axis_sizes(mesh).get(axis, 1)
    t = t.detach().contiguous().clone()
    return t if n == 1 else _all_reduce(t, mesh, axis, n,
                                        dist.ReduceOp.MAX)


def gather(t: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """The full tensor of which ``t`` is this rank's shard under
    ``sharding``.  A collective: every rank of the mesh calls it.  A
    replicated ``t`` is returned as it is."""
    sizes, mesh = sharding.sizes, sharding.mesh
    for d, e in enumerate(sharding.spec):
        for a in reversed(entry_names(e)):      # minor axis first
            if sizes[a] > 1:
                t = all_gather_dim(t, mesh, a, sizes[a], d)
    return t.contiguous()


def reduce_shard(t: torch.Tensor, sharding: Sharding,
                 over: tuple[str, ...],
                 dtype: torch.dtype | None = None) -> torch.Tensor:
    """This rank's shard under ``sharding`` of the sum of the full tensor
    ``t`` over the mesh axes ``over`` (the ranks along them hold different
    ``t``; along the other axes they hold the same ``t``, and each rank
    takes its own block of it).  The sum runs in ``dtype`` (default
    ``t``'s), cast after the local slicing.  A collective: every rank of
    the mesh calls it.  May return ``t``'s storage when nothing is summed
    or sliced."""
    sizes, mesh = sharding.sizes, sharding.mesh
    at = sharding.coordinate()
    names = [entry_names(e) for e in sharding.spec]
    # Local slices first (no traffic), then the reductions on what is left.
    for d, ns in enumerate(names):
        if not any(a in over for a in ns):
            for a in ns:
                size = t.shape[d] // sizes[a]
                t = t.narrow(d, at[a] * size, size)
    if dtype is not None:
        t = t.to(dtype)
    for d, ns in enumerate(names):
        if any(a in over for a in ns):
            for a in ns:
                if a not in over:
                    size = t.shape[d] // sizes[a]
                    t = t.narrow(d, at[a] * size, size)
                elif sizes[a] > 1:
                    t = _reduce_scatter_dim(t, mesh, a, sizes[a], d)
    t = t.contiguous()
    used = {a for ns in names for a in ns}
    for a in over:
        if a not in used and sizes[a] > 1:
            _all_reduce(t, mesh, a, sizes[a])
    return t


def gather_to_host(t: torch.Tensor, sharding: Sharding,
                   dst: int = 0) -> torch.Tensor | None:
    """The full tensor of which ``t`` is this rank's shard, on the host
    of rank ``dst`` (None on the others).  A collective over the whole
    world (the mesh must span it): every rank sends a host copy of its
    shard, and ``dst`` puts each at its rank's block."""
    mesh = sharding.mesh
    mine = t.detach().to("cpu", copy=True).contiguous()
    rank = dist.get_rank()
    blocks = ([torch.empty_like(mine) for _ in range(dist.get_world_size())]
              if rank == dst else None)
    if rank != dst:
        _count("gather", "world", mine, 1)
    dist.gather(mine, blocks, dst=dst)
    if rank != dst:
        return None
    shape = sharding.full_shape(mine.shape)
    full = torch.empty(shape, dtype=mine.dtype)
    ranks = mesh.mesh.reshape(-1).tolist()
    for r, coord in zip(ranks, itertools.product(
            *(range(n) for n in mesh.mesh.shape))):
        sharding.local(full, coord).copy_(blocks[r])
    return full


def gather_scalar(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's 0-d ``x``, as a tensor of the mesh's shape on ``x``'s
    device, the same bits on every rank of the world.  A collective over
    the whole world (the mesh must span it)."""
    world = dist.get_world_size()
    out = torch.empty(world, dtype=x.dtype, device=x.device)
    _count("all_gather", "world", x.reshape(1), world - 1)
    dist.all_gather_into_tensor(out, x.reshape(1).contiguous())
    return out[mesh.mesh.to(x.device).long()]

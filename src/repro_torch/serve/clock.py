"""One clock for every rank of a mesh, for replaying an arrival trace
through a sharded session.

A sharded session is SPMD: every rank must issue the same sweeps with
the same inputs.  A replay's scheduler decides from its clock's readings
(which arrivals are due, when a sweep fires, how long a request waited),
so ranks that each read their own wall clock admit different batches
and their collectives stop matching.  ``MeshClock`` makes every reading
rank 0's: rank 0 reads its wall clock and broadcasts the reading to the
world.  Every rank's scheduler makes the same readings in the same
order, so each reading pairs with its twin on the other ranks and every
rank takes the same decisions by construction: the counterpart of the
reference's one controller driving a sharded session.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Callable

import torch
import torch.distributed as dist

from ..launch.mesh import axis_sizes

#: The clocks a replay may share over a mesh: each rank reads real time
#: on them, so rank 0's reading is as good as its own.
WALL_CLOCKS = (time.time, time.monotonic, time.perf_counter)


class MeshClock:
    """Reads ``base`` on the mesh's first rank and broadcasts the reading
    over the world group; a collective, so every rank must read it as
    often as the others and in the same order."""

    def __init__(self, base: Callable[[], float], mesh):
        ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
        if sorted(ranks) != list(range(dist.get_world_size())):
            raise ValueError(
                f"a MeshClock needs a mesh over the whole world: the mesh "
                f"holds ranks {ranks}, the world "
                f"{dist.get_world_size()}")
        self.base = base
        self.src = ranks[0]
        self._reading = torch.zeros((), dtype=torch.float64)

    def __call__(self) -> float:
        if dist.get_rank() == self.src:
            self._reading.fill_(self.base())
        dist.broadcast(self._reading, src=self.src)
        return float(self._reading)


@contextlib.contextmanager
def replay_clock(front, mesh, what: str):
    """Within the block, ``front`` (an ``IMPACTEngine`` or a ``ModelZoo``)
    reads the clock a trace replay needs on ``mesh``: on a mesh of more
    than one rank, rank 0's wall clock shared by a ``MeshClock``; else its
    own.  Its own clock is put back after.  Raises for an injected clock
    on such a mesh: each rank would read it alone, and its readings could
    diverge."""
    own = front.clock
    if (mesh is None or math.prod(axis_sizes(mesh).values()) == 1
            or isinstance(own, MeshClock)):
        yield
        return
    if own not in WALL_CLOCKS:
        raise ValueError(
            f"{what} on a mesh of more than one rank needs a wall clock "
            f"(time.monotonic, time.perf_counter or time.time), which "
            f"rank 0 reads for every rank; the injected clock {own!r} "
            f"reads on each rank alone")
    front._set_clock(MeshClock(own, mesh))
    try:
        yield
    finally:
        front._set_clock(own)

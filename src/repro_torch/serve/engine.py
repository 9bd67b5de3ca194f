"""Serving scheduling primitives (the part of ``repro.serve.engine`` that
the IMPACT crossbar front uses): backpressure, tail-latency summaries,
the continuous-batching ``SlotTable`` and the ``BatchingQueue``.  The LM
``Engine`` comes with the LM slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch


class Backpressure(RuntimeError):
    """Raised when an engine cannot accept more work: every slot is
    occupied and the admission queue is at capacity.  Callers shed load or
    retry after a ``step``; ``try_submit`` converts it to ``None``."""


def latency_percentiles(latencies_s: Sequence[float]) -> dict[str, float]:
    """Tail-latency summary (p50/p95/p99/mean/max seconds) of a sample."""
    if len(latencies_s) == 0:
        return {}
    a = np.asarray(latencies_s, dtype=float)
    return {
        "p50_s": float(np.percentile(a, 50)),
        "p95_s": float(np.percentile(a, 95)),
        "p99_s": float(np.percentile(a, 99)),
        "mean_s": float(a.mean()),
        "max_s": float(a.max()),
        "n": int(a.size),
    }


class SlotTable:
    """Fixed-capacity lane table for continuous batching.

    ``admit`` places a payload in the lowest free slot (stable lane
    indices keep the device-side literal buffer aligned with the table);
    ``release`` frees it; ``valid_mask`` is the per-lane validity vector
    the padded kernels consume.  ``compact`` densifies occupied lanes
    into a prefix and returns the (src, dst) moves applied.
    """

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.slots: list[Any | None] = [None] * capacity
        self._n = 0

    @property
    def occupancy(self) -> int:
        return self._n

    @property
    def free(self) -> int:
        return self.capacity - self._n

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def occupied(self) -> Iterator[tuple[int, Any]]:
        return ((i, s) for i, s in enumerate(self.slots) if s is not None)

    def admit(self, item: Any) -> int:
        """Place ``item`` in the lowest free slot; raises Backpressure when
        the table is full."""
        for i, s in enumerate(self.slots):
            if s is None:
                self.slots[i] = item
                self._n += 1
                return i
        raise Backpressure(f"all {self.capacity} slots occupied")

    def release(self, i: int) -> Any:
        item = self.slots[i]
        if item is None:
            raise KeyError(f"slot {i} is already free")
        self.slots[i] = None
        self._n -= 1
        return item

    def valid_mask(self) -> np.ndarray:
        return np.array([s is not None for s in self.slots], dtype=bool)

    def compact(self) -> list[tuple[int, int]]:
        """Move occupied slots into a dense prefix (stable order); returns
        the (src, dst) lane moves applied."""
        moves: list[tuple[int, int]] = []
        dst = 0
        for src in range(self.capacity):
            if self.slots[src] is None:
                continue
            if src != dst:
                self.slots[dst] = self.slots[src]
                self.slots[src] = None
                moves.append((src, dst))
            dst += 1
        return moves


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray
    max_new: int
    arrived: float = dataclasses.field(default_factory=time.time)


class BatchingQueue:
    """Request accumulator: flushes when full or stale.  ``clock`` is the
    same injectable time source the owning engine stamps requests with, so
    staleness is measured on one clock."""

    def __init__(self, max_batch: int = 8, max_wait_s: float = 0.05,
                 clock: Callable[[], float] = time.time):
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.clock = clock
        self.pending: list[Request] = []

    def add(self, req: Request):
        self.pending.append(req)

    def ready(self) -> bool:
        if not self.pending:
            return False
        if len(self.pending) >= self.max_batch:
            return True
        return (self.clock() - self.pending[0].arrived) >= self.max_wait_s

    def take(self) -> list[Request]:
        batch, self.pending = (self.pending[:self.max_batch],
                               self.pending[self.max_batch:])
        return batch

    def take_n(self, n: int) -> list[Request]:
        """Dequeue up to ``n`` requests FIFO (continuous-batching admission
        takes exactly as many as there are free slots)."""
        batch, self.pending = self.pending[:n], self.pending[n:]
        return batch

    @staticmethod
    def pad(batch: list[Request], pad_id: int = 0,
            ) -> tuple[torch.Tensor, torch.Tensor]:
        """Right-align prompts into (B, S_max) int32 + validity mask."""
        s_max = max(r.tokens.shape[0] for r in batch)
        toks = np.full((len(batch), s_max), pad_id, np.int32)
        mask = np.zeros((len(batch), s_max), bool)
        for i, r in enumerate(batch):
            s = r.tokens.shape[0]
            toks[i, s_max - s:] = r.tokens
            mask[i, s_max - s:] = True
        return torch.from_numpy(toks), torch.from_numpy(mask)

"""Serving engine (the port of ``repro.serve.engine``): batched prefill +
decode with KV / recurrent caches, and the scheduling primitives the LM
and the IMPACT crossbar fronts share.

One ``Engine`` drives every LM family: attention models carry KV caches
(MLA: compressed latents), zamba2 ring buffers and SSM states, rwkv6 an
O(1) recurrent state.  ``generate`` takes equal-length prompt batches;
``serve_continuous`` runs a ``SlotTable`` of lanes where a finished
request releases its slot and queued ones are admitted between decode
steps.  The reference jits ``prefill`` / ``decode_step`` and donates the
cache; here both are eager calls and ``decode_step`` updates the cache
in place.  Sampling at a temperature draws from a ``torch.Generator``
seeded from ``seed``: the reference's JAX key stream is not reproduced,
so the two engines agree on greedy tokens only.

``BatchingQueue``, ``SlotTable`` and ``latency_percentiles`` are shared
with the IMPACT crossbar front (``serve.impact_engine``).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from ..models.base import leaves
from ..tracing import PID_REQUESTS, Tracer


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


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    temperature: float = 0.0        # 0 => greedy
    eos_id: int | None = None


def _scatter_cache(cache: dict, cache_axes: dict, new_cache: dict,
                   src_rows, dst_rows) -> dict:
    """Write lane ``src_rows[j]`` of ``new_cache`` into lane
    ``dst_rows[j]`` of ``cache`` on every leaf, in place; returns
    ``cache``.  The batch axis is not leading on every leaf (stacked
    leaves are (layers, batch, ...)), so each leaf's lane axis is found in
    the model's ``cache_axes`` tree.  The source rows are copied out
    before any write: on the first admission ``cache`` is ``new_cache``
    itself."""
    got, new = dict(leaves(cache)), dict(leaves(new_cache))
    axes = dict(leaves(cache_axes))
    if not set(got) == set(new) == set(axes):
        raise ValueError(
            f"cache trees disagree: {len(got)} cache leaves vs {len(new)} "
            f"new-cache leaves vs {len(axes)} cache_axes leaves; the "
            f"model's cache_axes() no longer mirrors its cache structure")
    for path, c in got.items():
        b = axes[path].index("batch")
        src = torch.as_tensor(src_rows, dtype=torch.long, device=c.device)
        dst = torch.as_tensor(dst_rows, dtype=torch.long, device=c.device)
        rows = new[path].index_select(b, src).to(c.dtype)
        c.index_copy_(b, dst, rows)
    return cache


class Engine:
    """LM serving engine over a port model (``models.build``).  ``trace``
    (a ``repro_torch.tracing.Tracer``) records the decode timeline as
    Chrome-tracing spans: ``prefill`` / ``decode`` regions on the scheduler
    track and one ``request`` span (arrival -> completion, slot id as an arg)
    per request in ``serve_continuous``, the span vocabulary of the IMPACT
    crossbar engine."""

    def __init__(self, model, cfg: ServeConfig, *,
                 trace: Tracer | None = None):
        self.model = model
        self.cfg = cfg
        self.trace = trace

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill(self, tokens: torch.Tensor):
        B, S = tokens.shape[:2]
        pos = torch.arange(S, dtype=torch.int32,
                           device=self.device).expand(B, S)
        return self.model.prefill(tokens, pos, self.cfg.max_len)

    def _sample(self, logits: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
        """logits (B, 1, V) or (B, 1, C, V) -> next tokens (B, 1[, C])
        int32: the argmax at temperature 0, else a draw from ``generator``
        of softmax(logits / temperature)."""
        if self.cfg.temperature <= 0.0:
            return logits.argmax(-1).to(torch.int32)
        probs = torch.softmax(logits / self.cfg.temperature, dim=-1)
        draw = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                 generator=generator)
        return draw.reshape(probs.shape[:-1]).to(torch.int32)

    def generate(self, prompts, n_tokens: int, *,
                 seed: int = 0) -> tuple[torch.Tensor, dict]:
        """prompts (B, S[, C]) -> (generated (B, n_tokens[, C]), stats)."""
        prompts = torch.as_tensor(prompts, device=self.device)
        B, S = prompts.shape[:2]
        gen = torch.Generator(self.device).manual_seed(seed)
        t0 = time.time()
        logits, cache = self._prefill(prompts)
        self._sync()
        t_prefill = time.time() - t0
        if self.trace is not None:
            self.trace.span("prefill", t0, t0 + t_prefill,
                            args=dict(batch=B, seq=S))

        tok = self._sample(logits, gen)
        out = [tok]
        t0 = time.time()
        for i in range(n_tokens - 1):
            p = torch.full((B, 1), S + i, dtype=torch.int32,
                           device=self.device)
            logits, cache = self.model.decode_step(cache, tok, p)
            tok = self._sample(logits, gen)
            out.append(tok)
        self._sync()
        t_decode = time.time() - t0
        if self.trace is not None:
            self.trace.span("decode", t0, t0 + t_decode,
                            args=dict(batch=B, n_tokens=n_tokens))
        stats = dict(
            prefill_s=t_prefill, decode_s=t_decode,
            tokens=B * n_tokens,
            decode_tok_per_s=B * max(n_tokens - 1, 1) / max(t_decode, 1e-9))
        return torch.cat(out, dim=1), stats

    # -- continuous batching ------------------------------------------------
    def _is_eos(self, tok: np.ndarray) -> bool:
        if self.cfg.eos_id is None:
            return False
        return int(np.asarray(tok).ravel()[0]) == self.cfg.eos_id

    def serve_continuous(self, requests: list[Request], *,
                         capacity: int = 4, seed: int = 0,
                         ) -> tuple[dict[int, np.ndarray], dict]:
        """Continuous-batching decode: a ``SlotTable`` of ``capacity``
        lanes where a request releases its slot the step it finishes
        (``max_new`` or EOS) and queued requests are admitted into freed
        lanes between decode steps.

        Admission prefills the newcomers as a full-capacity batch (rows
        past the newcomers repeat the last one) and scatters their lanes
        into the live cache at the admitted slots.  Prompts must share one
        length; per-request end-to-end latency percentiles come back in
        the stats.

        Returns ({rid: generated tokens (n_i, ...)}, stats).
        """
        if not requests:
            raise ValueError("serve_continuous needs at least one request")
        S = requests[0].tokens.shape[0]
        if not all(r.tokens.shape[0] == S for r in requests):
            raise ValueError(
                "serve_continuous requires equal-length prompts (one "
                "prefill shape is shared across admissions)")
        axes = self.model.cache_axes()
        table = SlotTable(capacity)
        pending = collections.deque(requests)
        trail = requests[0].tokens.shape[1:]
        tok = np.zeros((capacity, 1) + trail, np.int32)
        pos = np.zeros((capacity,), np.int32)
        n_gen = np.zeros((capacity,), np.int32)
        gen = torch.Generator(self.device).manual_seed(seed)
        cache = None
        out: dict[int, list[np.ndarray]] = {}
        lat: dict[int, float] = {}
        t0 = time.time()
        steps = 0

        def finish(slot: int, req: Request) -> None:
            table.release(slot)
            done = time.time()
            lat[req.rid] = done - req.arrived
            if self.trace is not None:
                self.trace.span("request", req.arrived, done, tid=req.rid,
                                pid=PID_REQUESTS,
                                args=dict(rid=req.rid, slot=slot))

        while pending or table.occupancy:
            free = table.free_slots()
            if pending and free:
                k = min(len(free), len(pending))
                reqs = [pending.popleft() for _ in range(k)]
                t_adm = time.time()
                ptoks = np.stack([reqs[min(i, k - 1)].tokens
                                  for i in range(capacity)])
                logits, new_cache = self._prefill(
                    torch.as_tensor(ptoks, device=self.device))
                first = self._sample(logits, gen).cpu().numpy()
                slots = [table.admit(r) for r in reqs]
                if self.trace is not None:
                    self.trace.span("prefill", t_adm, time.time(),
                                    args=dict(admitted=k, slots=slots,
                                              occupancy=table.occupancy))
                base = cache if cache is not None else new_cache
                cache = _scatter_cache(base, axes, new_cache, np.arange(k),
                                       np.asarray(slots))
                for i, (s, r) in enumerate(zip(slots, reqs)):
                    out[r.rid] = [first[i]]
                    tok[s] = first[i]
                    pos[s] = S
                    n_gen[s] = 1
                    if n_gen[s] >= r.max_new or self._is_eos(first[i]):
                        finish(s, r)
            if table.occupancy:
                t_dec = time.time()
                logits, cache = self.model.decode_step(
                    cache, torch.as_tensor(tok, device=self.device),
                    torch.as_tensor(pos, device=self.device)[:, None])
                nxt = self._sample(logits, gen).cpu().numpy()
                steps += 1
                if self.trace is not None:
                    self.trace.span("decode_step", t_dec, time.time(),
                                    args=dict(step=steps,
                                              occupancy=table.occupancy))
                for s, r in list(table.occupied()):
                    out[r.rid].append(nxt[s])
                    tok[s] = nxt[s]
                    pos[s] += 1
                    n_gen[s] += 1
                    if n_gen[s] >= r.max_new or self._is_eos(nxt[s]):
                        finish(s, r)
        gen_out = {rid: np.concatenate(t, axis=0) for rid, t in out.items()}
        stats = dict(decode_steps=steps, wall_s=time.time() - t0,
                     requests=len(requests), capacity=capacity,
                     latency=latency_percentiles(list(lat.values())))
        return gen_out, stats

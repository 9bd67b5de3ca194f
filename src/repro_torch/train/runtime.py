"""Fault-tolerant training loop: auto-resume, periodic async checkpoints,
straggler detection, a heartbeat (the port of ``repro.train.runtime``).

``TrainLoop`` wraps a train step with the controller-side machinery:

* **auto-resume**: on start, restore the latest published checkpoint
  (atomic manifests mean a crash mid-save rolls back to the step before);
* **periodic async checkpoints** every ``save_every`` steps, and a final
  blocking one;
* **stragglers**: each step's wall (the step, then a device
  synchronize, as the reference blocks on its state) is held to
  ``deadline_factor`` x the median of the last 20; a breach counts, calls
  ``on_straggler(step, seconds)``, and ``straggler_patience`` breaches in
  a row force a checkpoint so that a scheduler could move the job;
* **failure injection**: ``fail_at_step`` raises ``SimulatedFailure``
  before that step; a new loop resumes bit-exact from the last
  checkpoint;
* **heartbeat**: ``HEARTBEAT`` in the checkpoint directory, every
  ``heartbeat_every`` steps.

With ``state_shardings`` (the state's tree of ``sharding.layout
.Sharding``, a ZeRO state of shards) every rank of the mesh runs the
loop: saves and the resume gather and place each leaf
(``CheckpointManager(shardings=)``).  A save is a collective, so every
decision that leads to one is the same on every rank: each step's time
is the slowest rank's (one all-reduce of the ranks' step times), the
straggler count follows from it alike everywhere, and ``save_every`` and
the final save are counted in steps.  Rank 0 alone writes the heartbeat.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import time
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist

from ..device import resolve_device
from .checkpoint import CheckpointManager

Tree = Any


@dataclasses.dataclass
class RuntimeConfig:
    ckpt_dir: str
    max_steps: int = 100
    save_every: int = 20
    keep: int = 3
    deadline_factor: float = 3.0
    straggler_patience: int = 3
    heartbeat_every: int = 10
    fail_at_step: int | None = None      # test hook


class SimulatedFailure(RuntimeError):
    pass


class TrainLoop:
    """``train_step(state, batch, seed) -> (state, metrics)`` over
    ``data_iter`` on ``device`` (default ``cuda``, raising without a card;
    the state's tensors live there)."""

    def __init__(self, train_step: Callable, state: Tree,
                 data_iter: Iterator[dict], cfg: RuntimeConfig, *,
                 state_shardings: Tree | None = None,
                 on_straggler: Callable[[int, float], None] | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.train_step = train_step
        self.state = state
        self.data_iter = data_iter
        self.cfg = cfg
        self.mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.state_shardings = state_shardings
        self.on_straggler = on_straggler
        self.step_times: list[float] = []
        self.straggler_events = 0
        self.metrics_log: list[dict] = []

    # -- resume ------------------------------------------------------------
    def maybe_resume(self) -> int:
        if self.mgr.latest_step() is None:
            return 0
        self.state, step = self.mgr.restore(
            self.state, shardings=self.state_shardings)
        return step

    def _save(self, step: int, blocking: bool):
        self.mgr.save(step, self.state, blocking=blocking,
                      shardings=self.state_shardings)

    def _heartbeat(self, step: int):
        if self.state_shardings is not None and dist.get_rank() != 0:
            return
        hb = pathlib.Path(self.cfg.ckpt_dir) / "HEARTBEAT"
        hb.write_text(json.dumps({"step": step, "t": time.time()}))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _agreed(self, dt: float) -> float:
        """The step's time as every rank sees it: the slowest rank's on a
        mesh (an exact max, the same on every rank), else ``dt``."""
        if self.state_shardings is None:
            return dt
        t = torch.tensor([dt], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    # -- main loop -----------------------------------------------------------
    def run(self, seed: int = 0) -> Tree:
        start = self.maybe_resume()
        consecutive_slow = 0
        for step in range(start, self.cfg.max_steps):
            if self.cfg.fail_at_step is not None \
                    and step == self.cfg.fail_at_step:
                raise SimulatedFailure(f"injected failure at step {step}")
            batch = next(self.data_iter)
            t0 = time.time()
            self.state, metrics = self.train_step(self.state, batch,
                                                  seed + step)
            self._sync()
            dt = self._agreed(time.time() - t0)
            self.step_times.append(dt)
            self.metrics_log.append({k: float(v) for k, v in metrics.items()})

            # Straggler detection against the running median.
            if len(self.step_times) >= 5:
                med = statistics.median(self.step_times[-20:])
                if dt > self.cfg.deadline_factor * max(med, 1e-6):
                    self.straggler_events += 1
                    consecutive_slow += 1
                    if self.on_straggler:
                        self.on_straggler(step, dt)
                    if consecutive_slow >= self.cfg.straggler_patience:
                        self._save(step + 1, blocking=False)
                        consecutive_slow = 0
                else:
                    consecutive_slow = 0

            if (step + 1) % self.cfg.save_every == 0:
                self._save(step + 1, blocking=False)
            if (step + 1) % self.cfg.heartbeat_every == 0:
                self._heartbeat(step + 1)
        self._save(self.cfg.max_steps, blocking=True)
        return self.state

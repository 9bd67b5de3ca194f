"""AdamW with f32 master weights and dtype-configurable moments (the port
of ``repro.train.optimizer``).

The ``TrainState`` holds the f32 master parameters and the first and
second moments, stored in ``AdamWConfig.moment_dtype`` (bf16 for
grok-1-314b) and updated in f32: clip by global norm, bias corrections,
decoupled weight decay, the reference's formulas op for op.

Trees are nested dicts and lists of tensors (``models.base.leaves`` /
``tree_map``), the reference's pytrees.  ``apply_updates`` writes the new
parameters and moments into the state's tensors in place and returns a
``TrainState`` over them: the reference returns new arrays, but eager
PyTorch would then hold two states at once (2 x 33.5 GB for llama3-8b
eight layers deep).  Plain PyTorch: the reference has no Pallas kernel
here.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models.base import leaves, tree_map

F32 = torch.float32
Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    moment_dtype: torch.dtype = torch.float32

    def schedule(self, step) -> torch.Tensor:
        """Linear warmup -> constant, in f32 (``step`` an int or a
        tensor)."""
        step = torch.as_tensor(step)
        warm = torch.clamp(step.to(F32) / max(self.warmup_steps, 1),
                           max=1.0)
        return self.lr * warm


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor   # () int32
    params: Tree         # f32 master
    m: Tree              # first moment (moment_dtype)
    v: Tree              # second moment (moment_dtype)


def _flat(tree: Tree) -> list[torch.Tensor]:
    return [t for _, t in leaves(tree)]


def init_state(params: Tree, cfg: AdamWConfig) -> TrainState:
    """Zero moments of ``cfg.moment_dtype`` beside ``params`` (kept, not
    copied), step 0 on the device of the first leaf."""
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                  device=p.device)
    first = _flat(params)[0]
    return TrainState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      params=params, m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, the leaves' sums
    added in tree order as the reference's Python ``sum``."""
    total = 0
    for g in _flat(tree):
        total = total + torch.sum(torch.square(g.to(F32)))
    return torch.sqrt(total)


def apply_updates(state: TrainState, grads: Tree,
                  cfg: AdamWConfig) -> tuple[TrainState, dict]:
    """One AdamW step -> (state over the updated tensors, metrics).  The
    parameters and moments are updated in place (module docstring)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = cfg.schedule(step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - torch.pow(b1, step.to(F32))
    bc2 = 1.0 - torch.pow(b2, step.to(F32))

    with torch.no_grad():
        for p, g, m, v in zip(_flat(state.params), _flat(grads),
                              _flat(state.m), _flat(state.v)):
            g = g.to(F32) * clip
            m32 = b1 * m.to(F32) + (1 - b1) * g
            v32 = b2 * v.to(F32) + (1 - b2) * torch.square(g)
            del g
            update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            p.sub_(lr * (update + cfg.weight_decay * p))
            del update
            m.copy_(m32)
            v.copy_(v32)
    return (TrainState(step=step, params=state.params, m=state.m,
                       v=state.v),
            {"grad_norm": gnorm, "lr": lr})

"""CoTM readout head: the paper's technique as an LM feature (the port of
``repro.models.tm_head``).

Pooled backbone hidden states are booleanized (thermometer encoding over
standardized features, original + negated bits, the paper's
data-preparation step) and classified by the CoTM clause/class
computation.  Inference rides ``kernels.ops.fused_cotm`` (the hand-written
``fused_cotm_i32`` kernel on a card, its plain version on the CPU);
training rides ``core.train.train_step_batch`` on frozen backbone
features.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.booleanize import booleanize
from ..core.cotm import CoTMConfig, CoTMParams, include_mask
from ..core.train import train_step_batch
from ..device import resolve_device
from ..kernels import ops
from .config import TMHeadConfig


@dataclasses.dataclass(frozen=True)
class TMHead:
    cfg: TMHeadConfig
    d_features: int

    @property
    def cotm_cfg(self) -> CoTMConfig:
        return CoTMConfig(
            n_literals=2 * self.d_features * self.cfg.bits_per_feature,
            n_clauses=self.cfg.n_clauses,
            n_classes=self.cfg.n_classes,
            n_states=self.cfg.n_states,
            threshold=self.cfg.threshold)

    def init(self, generator: torch.Generator | None = None, *,
             device: str | torch.device | None = None) -> CoTMParams:
        """Fresh head parameters on ``generator``'s device, or, without a
        generator, from a new one seeded 0 on ``device`` (default
        ``cuda``, which raises without a card)."""
        if generator is None:
            generator = torch.Generator(resolve_device(device)).manual_seed(0)
        elif device is not None and \
                resolve_device(device) != generator.device:
            raise ValueError(f"device {device!r} differs from the "
                             f"generator's {generator.device}")
        return self.cotm_cfg.init(generator)

    def booleanize(self, features: torch.Tensor) -> torch.Tensor:
        """features (B, d) -> literals (B, 2*d*bits) bool.

        Features are squashed to (0, 1) with a logistic over their own
        scale (the population standard deviation, as ``jnp.std``) so the
        thermometer thresholds are calibration-free.
        """
        f32 = features.to(torch.float32)
        mu = f32.mean(dim=-1, keepdim=True)
        sd = f32.std(dim=-1, keepdim=True, correction=0) + 1e-6
        squashed = torch.sigmoid((f32 - mu) / sd)
        return booleanize(squashed, n_bits=self.cfg.bits_per_feature)

    def scores(self, params: CoTMParams, features: torch.Tensor, *,
               impl: str = "cuda") -> torch.Tensor:
        """Class scores (B, M) int32 through the fused clause + class
        kernel."""
        lits = self.booleanize(features)
        inc = include_mask(params.ta_state, self.cotm_cfg.n_states)
        return ops.fused_cotm(lits, inc, params.weights.T, impl=impl)

    def predict(self, params: CoTMParams, features: torch.Tensor, *,
                impl: str = "cuda") -> torch.Tensor:
        return torch.argmax(self.scores(params, features, impl=impl), dim=-1)

    def train_step(self, params: CoTMParams, features: torch.Tensor,
                   labels: torch.Tensor,
                   generator: torch.Generator) -> CoTMParams:
        """One CoTM feedback step on frozen backbone features."""
        lits = self.booleanize(features)
        return train_step_batch(params, lits, labels, generator,
                                self.cotm_cfg)


def pool_features(hidden: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean-pool (B, S, d) -> (B, d) over valid positions."""
    if mask is None:
        return hidden.mean(dim=1)
    m = mask.to(hidden.dtype)[..., None]
    return (hidden * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)

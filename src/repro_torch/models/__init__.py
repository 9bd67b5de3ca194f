"""Model zoo of the port (``repro.models``): the transformer family and the
CoTM readout head.

``build(cfg, device=None)`` returns a ``TransformerLM`` for the dense,
moe, vlm and audio families.  The ssm (rwkv6) and hybrid (zamba2)
families are not ported yet (ROADMAP Queue 1 item 16 (b)): ``build``
refuses them.
"""
import torch

from .base import P, ParamTree, abstract, axes_tree, count_params
from .config import (MLAConfig, MoEConfig, ModelConfig, SHAPES, ShapeSpec,
                     SSMConfig, TMHeadConfig, torch_dtype)
from .tm_head import TMHead, pool_features
from .transformer import TransformerLM


def build(cfg: ModelConfig, *,
          device: str | torch.device | None = None) -> TransformerLM:
    """The model of ``cfg`` on ``device`` (default ``cuda``; ``"meta"``
    allocates nothing), parameters uninitialized: call ``init``."""
    if cfg.ssm is not None:
        raise NotImplementedError(
            f"{cfg.name} is a {cfg.family} model; the ssm and hybrid "
            f"families are not ported yet (ROADMAP Queue 1 item 16 (b))")
    return TransformerLM(cfg, device=device)


__all__ = [
    "build", "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
    "TMHeadConfig", "ShapeSpec", "SHAPES", "TransformerLM", "TMHead",
    "pool_features", "P", "ParamTree", "abstract", "axes_tree",
    "count_params", "torch_dtype",
]

"""Model zoo of the port (``repro.models``): one builder for the ten
architectures, and the CoTM readout head.

``build(cfg, ctx=NULL_CTX, device=None)`` dispatches on the family, as
the reference's ``build(cfg, ctx)``:

* dense / moe / vlm / audio -> ``TransformerLM``
* ssm (rwkv6)               -> ``RWKV6LM``
* hybrid (mamba2 + shared attention) -> ``Zamba2LM``

All three are ``StackedLM``s with the same interface: ``decls`` /
``init`` / ``abstract`` / ``n_params``, ``forward``, ``hidden``, ``loss``,
``init_cache`` / ``cache_axes`` / ``prefill`` / ``decode_step``.
"""
import torch

from .base import (NULL_CTX, P, ParamTree, ShardCtx, StackedLM, abstract,
                   axes_tree, count_params)
from .config import (MLAConfig, MoEConfig, ModelConfig, SHAPES, ShapeSpec,
                     SSMConfig, TMHeadConfig, torch_dtype)
from .tm_head import TMHead, pool_features
from .rwkv6 import RWKV6LM
from .transformer import TransformerLM
from .zamba2 import Zamba2LM


def build(cfg: ModelConfig, ctx: ShardCtx = NULL_CTX, *,
          device: str | torch.device | None = None) -> StackedLM:
    """The model of ``cfg`` on ``device`` (default ``cuda``; ``"meta"``
    allocates nothing), parameters uninitialized: call ``init``.  The
    model keeps ``ctx`` (``model.ctx``), the sharding context of its
    logical axes."""
    if cfg.ssm is not None and cfg.hybrid_attn_every > 0:
        return Zamba2LM(cfg, ctx, device=device)
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return RWKV6LM(cfg, ctx, device=device)
    return TransformerLM(cfg, ctx, device=device)


__all__ = [
    "build", "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
    "TMHeadConfig", "ShapeSpec", "SHAPES", "StackedLM", "TransformerLM",
    "RWKV6LM", "Zamba2LM", "TMHead", "pool_features", "P", "ParamTree",
    "abstract", "axes_tree", "count_params", "torch_dtype", "ShardCtx",
    "NULL_CTX",
]

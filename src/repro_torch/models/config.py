"""Unified model configuration for the 10 assigned architectures (the
port of ``repro.models.config``).

One frozen dataclass drives every family (dense / moe / vlm / audio / ssm /
hybrid); family-specific sub-configs are optional fields.  Exact published
dimensions live in ``repro_torch.configs.<arch_id>``.

The fields the reference lacks (``MoEConfig``'s ``capacity_factor=None``,
``norm_topk_prob`` and ``router_f32``, and ``ModelConfig.rope_scaling``)
default to the reference's mathematics, so every registry config still
equals the reference's on its fields; a published model's own settings
come from its config module's ``published()`` (DeepSeek-V2-Lite's
dropless, un-renormalised, f32-router, YaRN forward).

``dtype`` / ``param_dtype`` keep the reference's strings (``"bfloat16"``,
``"float32"``), so a config compares equal field by field with the
reference's; ``torch_dtype`` is the one place that resolves them.
``remat`` is read by the models under autograd (``StackedLM.remat``),
``grad_accum_dtype`` by the train step and ``opt_moment_dtype`` by the
callers that build an ``AdamWConfig`` from a config.  ``scan_layers``
and ``zero3`` are the reference's compilation and mesh knobs: the port
reads neither, and they stay so that the configs stay equal.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(dtype: Any) -> torch.dtype:
    """A config's dtype string (or a ``torch.dtype``) -> ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}; expected one of "
                         f"{sorted(DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0              # shared (always-on) experts
    capacity_factor: float | None = 1.25   # None: dropless (inference)
    aux_loss_weight: float = 0.01
    first_dense_layers: int = 0    # leading layers that use a dense FFN
    d_ff_dense: int | None = None  # FFN width of those dense layers
    norm_topk_prob: bool = True    # renormalise the top-k probabilities
    router_f32: bool = False       # router logits from f32 operands


@dataclasses.dataclass(frozen=True)
class YaRNConfig:
    """YaRN rope scaling (``rope_scaling`` of type ``"yarn"`` in a
    Hugging Face config), as DeepSeek-V2 publishes it.  Only
    ``mscale == mscale_all_dim`` is taken: cos and sin then keep their
    scale of one, as in every published DeepSeek-V2."""
    factor: float
    original_max_position_embeddings: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float

    def __post_init__(self):
        if self.mscale != self.mscale_all_dim:
            raise ValueError(
                f"YaRN with mscale {self.mscale} != mscale_all_dim "
                f"{self.mscale_all_dim} scales cos and sin, which the port "
                f"does not implement")


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"        # mamba2 | rwkv6
    state_dim: int = 64         # N (mamba2) / head size (rwkv6)
    head_dim: int = 64          # P per SSM head
    expand: int = 2             # d_inner = expand * d_model (mamba2)
    n_groups: int = 1           # B/C groups (mamba2)
    conv_width: int = 4
    chunk: int = 128            # chunked-scan block length
    decay_lora: int = 64        # rwkv6 data-dependent decay LoRA rank


@dataclasses.dataclass(frozen=True)
class TMHeadConfig:
    """CoTM readout head (the paper's technique as an LM feature)."""
    n_classes: int = 10
    n_clauses: int = 500
    bits_per_feature: int = 1
    n_states: int = 128
    threshold: int = 32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    act: str = "silu"                    # MLP activation
    mlp_gated: bool = True               # SwiGLU/GeGLU vs plain MLP
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_style: str = "rope"             # rope | mrope | none
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    rope_scaling: YaRNConfig | None = None
    norm: str = "rms"                    # rms | layer
    tie_embeddings: bool = False
    logit_softcap: float | None = None
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    hybrid_attn_every: int = 0           # zamba2: shared attn block period
    modality: str = "text"               # text | vision_stub | audio_stub
    n_codebooks: int = 1                 # audio: EnCodec streams
    tm_head: TMHeadConfig | None = None
    # --- numerics / execution ---
    dtype: Any = "bfloat16"              # compute dtype
    param_dtype: Any = "float32"
    remat: bool = True                   # checkpoint each scan layer
    scan_layers: bool = True
    attn_chunk_q: int = 512
    attn_chunk_k: int = 2048
    # --- training memory policy (used by launch/train + dryrun) ---
    zero3: bool = False                  # shard params over "data" too
    opt_moment_dtype: Any = "float32"    # bf16 for the very largest models
    grad_accum_dtype: Any = "float32"    # bf16 halves the accumulator

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def smoke(self) -> "ModelConfig":
        """A reduced same-family config for CPU smoke tests."""
        changes: dict[str, Any] = dict(
            n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=128, vocab=256, head_dim=16,
            attn_chunk_q=32, attn_chunk_k=32,
            remat=False, zero3=False,
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff_expert=64,
                n_shared=min(self.moe.n_shared, 1),
                first_dense_layers=min(self.moe.first_dense_layers, 1),
                d_ff_dense=128 if self.moe.d_ff_dense else None)
        if self.mla is not None:
            changes["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                                       qk_rope_head_dim=8, v_head_dim=16)
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=16, chunk=16, decay_lora=8)
            changes["n_layers"] = 4 if self.hybrid_attn_every else 2
        if self.hybrid_attn_every:
            changes["hybrid_attn_every"] = 2
        if self.mrope_sections and self.rope_style == "mrope":
            changes["mrope_sections"] = (4, 2, 2)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str          # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode
    accum: int = 1               # gradient-accumulation microbatches (train)

    def smoke(self) -> "ShapeSpec":
        return dataclasses.replace(self, seq_len=min(self.seq_len, 64),
                                   global_batch=min(self.global_batch, 2),
                                   accum=1)


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train", accum=8),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

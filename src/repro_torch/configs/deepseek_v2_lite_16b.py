"""deepseek-v2-lite-16b [moe] — 27L d=2048 16H, MLA kv_lora=512,
d_ff_expert=1408, vocab 102400, MoE 2 shared + 64 routed top-6, first layer
dense (d_ff 10944).  [arXiv:2405.04434; hf]

``CONFIG`` is the reference's entry, field for field.  ``published()`` is
the model as its ``config.json`` publishes it
(https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json):
dropless routing (inference computes every routed pair),
``norm_topk_prob: false``, the gate's logits in f32, YaRN
``rope_scaling``, and bf16 weights as published.  Its
``routed_scaling_factor`` is 1, so the routed experts' sum is not
scaled.
"""
import dataclasses

from repro_torch.models.config import (MLAConfig, ModelConfig, MoEConfig,
                                       YaRNConfig)

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, act="silu",
    rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  first_dense_layers=1, d_ff_dense=10944),
)

#: ``rope_scaling`` of the published config (type ``"yarn"``).
YARN = YaRNConfig(factor=40.0, original_max_position_embeddings=4096,
                  beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                  mscale_all_dim=0.707)


def published(cfg: ModelConfig = CONFIG) -> ModelConfig:
    """``cfg`` (``CONFIG``, or a cut of it such as ``CONFIG.smoke()``) with
    the published model's settings: dropless, un-renormalised, f32-router
    routing, YaRN, bf16 weights with bf16 compute."""
    return dataclasses.replace(
        cfg, rope_scaling=YARN, param_dtype="bfloat16", dtype="bfloat16",
        moe=dataclasses.replace(cfg.moe, capacity_factor=None,
                                norm_topk_prob=False, router_f32=True))

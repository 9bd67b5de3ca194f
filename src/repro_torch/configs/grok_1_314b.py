"""grok-1-314b [moe] — 64L d=6144 48H (GQA kv=8) d_ff=32768, MoE 8e top-2,
vocab 131072.  [hf:xai-org/grok-1; unverified]

Training memory posture (read by the reference's trainer; the port's
inference models ignore it): ZeRO-3 and bf16 Adam moments.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab=131072, act="gelu",
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768),
    zero3=True, opt_moment_dtype="bfloat16", grad_accum_dtype="bfloat16",
)

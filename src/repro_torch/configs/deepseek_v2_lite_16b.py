"""deepseek-v2-lite-16b [moe] — 27L d=2048 16H, MLA kv_lora=512,
d_ff_expert=1408, vocab 102400, MoE 2 shared + 64 routed top-6, first layer
dense (d_ff 10944).  [arXiv:2405.04434; hf]
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

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

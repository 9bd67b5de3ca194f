"""qwen2-vl-2b [vlm] — 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

Modality frontend is a STUB per the assignment: ``input_specs`` supplies
precomputed patch embeddings (B, S_img, d); M-RoPE positions (3, B, S).
"""
from repro_torch.models.config import ModelConfig

VISION_TOKENS = 256   # stub: 16x16 patch grid per image

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm", modality="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151936, act="silu",
    rope_theta=1_000_000.0, rope_style="mrope", mrope_sections=(16, 24, 24),
)

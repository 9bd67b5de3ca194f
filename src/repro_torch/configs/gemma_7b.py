"""gemma-7b [dense] — 28L d=3072 16H (GQA kv=16) d_ff=24576 vocab=256000,
GeGLU, head_dim=256, tied embeddings.  [arXiv:2403.08295; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256_000, act="gelu", tie_embeddings=True,
    rope_theta=10_000.0,
)

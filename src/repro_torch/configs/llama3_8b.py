"""llama3-8b [dense] — 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
[arXiv:2407.21783; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256, act="silu",
    rope_theta=500_000.0,
)

"""zamba2-7b [hybrid] — 81L d=3584 Mamba2 (state=64) + ONE shared
attention block (32H kv=32, d_ff=14336) every 6 layers, vocab 32000.
[arXiv:2411.15242; unverified]

Runs the long_500k cell (Mamba2 state + ring-buffer shared attention in
the reference).
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, act="gelu",
    rope_theta=10_000.0,
    ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2,
                  n_groups=2, conv_width=4, chunk=16),
    hybrid_attn_every=6,
)

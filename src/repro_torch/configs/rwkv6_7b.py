"""rwkv6-7b [ssm] — Finch: 32L d=4096 (attn-free, data-dependent decay)
d_ff=14336 vocab=65536.  [arXiv:2404.05892; hf]

Runs the long_500k cell (O(1) recurrent state per token).
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
    d_ff=14336, vocab=65536, act="relu2", rope_style="none",
    ssm=SSMConfig(kind="rwkv6", state_dim=64, head_dim=64, chunk=16,
                  decay_lora=64),
)

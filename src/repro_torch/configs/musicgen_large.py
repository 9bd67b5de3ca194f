"""musicgen-large [audio] — 48L d=2048 32H (kv=32) d_ff=8192 vocab=2048,
decoder-only over EnCodec tokens (4 codebooks).  [arXiv:2306.05284; hf]

EnCodec frontend is a STUB: inputs are the 4 parallel token streams
(B, S, 4); embeddings summed, one LM head per codebook.  Adaptation (as
in the reference): learned positional embeddings replaced by RoPE.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio", modality="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, act="gelu", mlp_gated=False, norm="layer",
    rope_theta=10_000.0, n_codebooks=4,
)

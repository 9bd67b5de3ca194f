"""Training batch shapes and the synthetic token stream (the port of the
one-device part of ``repro.launch.specs``).

``synth_tokens`` is the reference's numpy Markov chain: the same tokens
for the same seed, bit for bit.  ``train_batch_specs`` gives the batch
tree of a training cell with its leading accumulation axis, as ``meta``
tensors by default (shapes and dtypes, nothing allocated), and
``train_batch_axes`` its logical axes, by which the ZeRO train step
splits the batch over the data axes; ``prefill_axes`` / ``decode_axes``
lay out the inputs of a tensor-parallel prefill and decode step (each
rank passes its block, ``ShardCtx.local``).  The reference's prefill /
decode specs, the dry run and the HLO checks stay in ROADMAP.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.config import ModelConfig, ShapeSpec

VLM_PATCH_TOKENS = 256   # qwen2-vl stub: patch embeddings per sample


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec, *,
                      device: str | torch.device = "meta") -> dict:
    """Batch tree (A, B, ...) with a leading grad-accumulation axis of
    ``shape.accum``: zeros on ``device`` (no data on ``"meta"``)."""
    A = shape.accum
    B = shape.global_batch // A
    if B * A != shape.global_batch:
        raise ValueError(f"global batch {shape.global_batch} is not a "
                         f"multiple of accum {A}")
    S = shape.seq_len
    z = lambda s, dt: torch.zeros(s, dtype=dt, device=device)
    if cfg.modality == "audio":
        return {"tokens": z((A, B, S, cfg.n_codebooks), torch.int32)}
    if cfg.modality == "vlm":
        return {"tokens": z((A, B, S - VLM_PATCH_TOKENS), torch.int32),
                "extra_embeds": z((A, B, VLM_PATCH_TOKENS, cfg.d_model),
                                  torch.bfloat16),
                "positions": z((A, 3, B, S), torch.int32)}
    return {"tokens": z((A, B, S), torch.int32)}


def train_batch_axes(cfg: ModelConfig) -> dict:
    """Logical axes of the train batch's leaves (the leading accumulation
    axis whole on every rank)."""
    if cfg.modality == "audio":
        return {"tokens": (None, "batch", None, None)}
    if cfg.modality == "vlm":
        return {"tokens": (None, "batch", None),
                "extra_embeds": (None, "batch", None, None),
                "positions": (None, None, "batch", None)}
    return {"tokens": (None, "batch", None)}


def prefill_axes(cfg: ModelConfig) -> dict:
    """Logical axes of a prefill's inputs (the reference's
    ``launch/specs.py:101``)."""
    if cfg.modality == "audio":
        return {"tokens": ("batch", None, None),
                "positions": ("batch", None)}
    if cfg.modality == "vlm":
        return {"tokens": ("batch", None),
                "extra_embeds": ("batch", None, None),
                "positions": (None, "batch", None)}
    return {"tokens": ("batch", None), "positions": ("batch", None)}


def decode_axes(cfg: ModelConfig) -> dict:
    """Logical axes of a decode step's tokens and positions (the
    reference's ``launch/specs.py:112``)."""
    tok = (("batch", None, None) if cfg.modality == "audio"
           else ("batch", None))
    pos = ((None, "batch", None) if cfg.rope_style == "mrope"
           else ("batch", None))
    return {"tokens": tok, "positions": pos}


def synth_tokens(cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0) -> np.ndarray:
    """Synthetic token stream with learnable n-gram structure: a Markov
    chain over min(vocab, 64) states, int32 (B, S), or (B, S, C) for the
    audio codebooks (each codebook the stream rolled by its index)."""
    rng = np.random.default_rng(seed)
    n_states = min(cfg.vocab, 64)
    trans = rng.dirichlet(np.ones(n_states) * 0.1, size=n_states)
    toks = np.zeros((batch, seq), np.int32)
    state = rng.integers(0, n_states, size=batch)
    for t in range(seq):
        toks[:, t] = state
        nxt = [rng.choice(n_states, p=trans[s]) for s in state]
        state = np.asarray(nxt)
    toks = toks % cfg.vocab
    if cfg.modality == "audio":
        return np.stack([np.roll(toks, c, axis=1) % cfg.vocab
                         for c in range(cfg.n_codebooks)], axis=-1)
    return toks

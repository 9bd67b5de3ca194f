"""Input specifications of every model input, and the synthetic token
stream (the port of ``repro.launch.specs``).

The dry run's contract (``launch.dryrun``): for each (arch, shape) cell
the exact tree that the step consumes, as ``meta`` tensors by default
(shapes and dtypes, nothing allocated); on a real device (``"cpu"``) the
same functions give the reference's ``concrete=True`` values (zeros).

* ``train_batch_specs`` — a training cell's batch with its leading
  accumulation axis; ``train_batch_axes`` its logical axes, by which the
  ZeRO train step splits the batch over the data axes;
* ``prefill_specs`` / ``decode_specs`` — a prefill's inputs, and a
  decode step's one new token with the cache at the cell's capacity
  (``model.init_cache``); ``prefill_axes`` / ``decode_axes`` lay them
  out on a mesh (each rank passes its block, ``ShardCtx.local``).

``synth_tokens`` is the reference's numpy Markov chain: the same tokens
for the same seed, bit for bit.
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


def prefill_specs(cfg: ModelConfig, shape: ShapeSpec, *,
                  device: str | torch.device = "meta") -> dict:
    """A prefill's inputs for ``shape.global_batch`` prompts of
    ``shape.seq_len`` positions: tokens (B, S) (audio: (B, S, C)) and
    positions (B, S); for the VLM, tokens of the S - VLM_PATCH_TOKENS
    text positions, the patch embeddings and M-RoPE positions (3, B,
    S)."""
    B, S = shape.global_batch, shape.seq_len
    z = lambda s, dt: torch.zeros(s, dtype=dt, device=device)
    if cfg.modality == "audio":
        return {"tokens": z((B, S, cfg.n_codebooks), torch.int32),
                "positions": z((B, S), torch.int32)}
    if cfg.modality == "vlm":
        return {"tokens": z((B, S - VLM_PATCH_TOKENS), torch.int32),
                "extra_embeds": z((B, VLM_PATCH_TOKENS, cfg.d_model),
                                  torch.bfloat16),
                "positions": z((3, B, S), torch.int32)}
    return {"tokens": z((B, S), torch.int32),
            "positions": z((B, S), torch.int32)}


def decode_specs(cfg: ModelConfig, shape: ShapeSpec, model, *,
                 device: str | torch.device = "meta") -> dict:
    """A decode step's inputs: one new token a row (B, 1) (audio: (B, 1,
    C)), its positions (B, 1) (M-RoPE: (3, B, 1)) and the cache at
    ``shape.seq_len`` capacity, ``model.init_cache(B, S)`` on
    ``device`` (a model on another device is rebuilt there, its
    parameters not drawn: on ``"meta"`` nothing is allocated)."""
    B, S = shape.global_batch, shape.seq_len
    z = lambda s: torch.zeros(s, dtype=torch.int32, device=device)
    tokens = z((B, 1, cfg.n_codebooks) if cfg.modality == "audio"
               else (B, 1))
    positions = z((3, B, 1) if cfg.rope_style == "mrope" else (B, 1))
    dev = torch.device(device)
    if model.device != dev:
        model = type(model)(model.cfg, model.ctx, device=dev)
    return {"tokens": tokens, "positions": positions,
            "cache": model.init_cache(B, S)}


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

"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE (the
port of ``repro.models.rope``).

M-RoPE splits the rotary half-dim into (temporal, height, width) sections,
each rotated by its own position stream; plain text positions set all three
streams equal, recovering standard RoPE exactly.

YaRN (``ModelConfig.rope_scaling``, a ``YaRNConfig``) is DeepSeek-V2's
``DeepseekV2YarnRotaryEmbedding``: the inverse frequencies blend the
interpolated ones (``/ factor``) and the original ones over a linear ramp
between the correction dimensions that ``beta_fast`` / ``beta_slow``
rotations at ``original_max_position_embeddings`` give.  Cos and sin keep
their scale of one (``YaRNConfig`` takes only ``mscale ==
mscale_all_dim``).  The attention's softmax scale takes
``yarn_get_mscale(factor, mscale_all_dim) ** 2`` (``attention.mla_forward``).
"""
from __future__ import annotations

import math

import torch


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str | None = None) -> torch.Tensor:
    """(head_dim//2,) f32 inverse frequencies."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def yarn_get_mscale(scale: float, mscale: float) -> float:
    """YaRN's attention-temperature factor (``yarn_get_mscale``)."""
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _yarn_correction_dim(rotations: float, dim: int, base: float,
                         max_pos: int) -> float:
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))
            / (2 * math.log(base)))


def yarn_freqs(head_dim: int, theta: float, yarn,
               device: torch.device | str | None = None) -> torch.Tensor:
    """(head_dim//2,) f32 YaRN inverse frequencies of ``yarn`` (a
    ``YaRNConfig``), as ``DeepseekV2YarnRotaryEmbedding`` computes them."""
    extra = rope_freqs(head_dim, theta, device)
    inter = 1.0 / (yarn.factor * theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    orig = yarn.original_max_position_embeddings
    low = max(math.floor(_yarn_correction_dim(yarn.beta_fast, head_dim,
                                              theta, orig)), 0)
    high = min(math.ceil(_yarn_correction_dim(yarn.beta_slow, head_dim,
                                              theta, orig)), head_dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp           # 1 where the original frequency stays
    return inter * (1 - keep) + extra * keep


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float, scaling=None) -> torch.Tensor:
    """positions (..., S) int -> angles (..., S, head_dim//2) f32; with
    ``scaling`` (a ``YaRNConfig``) at YaRN's frequencies."""
    inv = (rope_freqs(head_dim, theta, positions.device) if scaling is None
           else yarn_freqs(head_dim, theta, scaling, positions.device))
    return positions.to(torch.float32)[..., None] * inv


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple[int, int, int]) -> torch.Tensor:
    """positions (3, B, S) -> angles (B, S, head_dim//2).

    ``sections`` are half-dim section sizes (t, h, w); sum == head_dim//2.
    Each half-dim lane takes its section's stream through a one-hot pick
    (an exact sum of one term and two zeros), as the reference does.
    """
    half = head_dim // 2
    if positions.shape[0] != 3:
        raise ValueError(f"M-RoPE positions must be (3, B, S), got "
                         f"{tuple(positions.shape)}")
    if sum(sections) != half:
        raise ValueError(f"sections {sections} must sum to head_dim//2 = "
                         f"{half}")
    dev = positions.device
    inv = rope_freqs(head_dim, theta, dev)                     # (half,)
    ang = positions.to(torch.float32)[..., None] * inv         # (3,B,S,half)
    section_id = torch.repeat_interleave(
        torch.arange(3, device=dev), torch.tensor(sections, device=dev),
        output_size=half)        # known: a meta tensor cannot count it
    pick = torch.nn.functional.one_hot(section_id, 3).to(torch.float32)
    return torch.einsum("tbsh,ht->bsh", ang, pick)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) with D even; angles (B, S, D//2) -> rotated x.

    Uses the split-half convention (Llama/NeoX style).
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)   # (B, S, 1, half)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

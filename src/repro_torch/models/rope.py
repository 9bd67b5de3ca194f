"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE (the
port of ``repro.models.rope``).

M-RoPE splits the rotary half-dim into (temporal, height, width) sections,
each rotated by its own position stream; plain text positions set all three
streams equal, recovering standard RoPE exactly.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str | None = None) -> torch.Tensor:
    """(head_dim//2,) f32 inverse frequencies."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions (..., S) int -> angles (..., S, head_dim//2) f32."""
    inv = rope_freqs(head_dim, theta, positions.device)
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

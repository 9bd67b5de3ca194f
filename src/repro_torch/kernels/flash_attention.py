"""Causal flash attention for the prefill of DeepSeek-V2's multi-head
latent attention: the wrapper of ``flash_mla_prefill`` in
``csrc/flash_mla.cu`` and its plain PyTorch version.

``flash_prefill(q, k, v, *, scale)`` is causal self-attention of one
sequence of S positions (query row i sees keys 0..i) in MLA's layout: q
as its parts ((B, S, H, 128), (B, S, H, 64)), k as ((B, S, H, 128),
(B, S, 64)) with one rope key shared by every head, v (B, S, H, 128); it
returns (B, S, H, 128).  The kernel reads the parts where they lie,
without a concatenation or an expansion over heads.  Anything else (a
query offset, keys of another length, a rope key a head, whole 192-dim
operands) raises; ``models.attention.chunked_attention`` takes those.

Tensors on the CPU go to the plain version, ``flash_prefill_ref``, which
takes the same arguments; tensors on a CUDA device go to the kernel, or
the call raises: bf16 operands whose last dim is contiguous, with
16-byte aligned bases and strides (the tensor maps' rule).  The output
is allocated here, bf16 or f32 (``out_dtype``).  One call is one launch
on the current stream; the library is built and loaded on the first call
on a card.

Both versions compute the same tiles in the same order: 128 query rows
by 128 keys, query tile i reading key tiles 0..i (those wholly above the
diagonal skipped), a tile's logits (q . k) x scale in f32 from bf16
operands, the running max and sum in f32, P rounded to bf16 against the
running max of its tile before P . V, f32 accumulation, O / max(l,
1e-30).  They differ only in the order of summation and in the kernel's
``exp2f`` of log2(e)-scaled logits.  ``models.attention._flash_rows`` has
the same rounding points on (512, 2048) chunks, so P is rounded against
another running max.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import tracing
from . import _build
from .crossbar_mvm import on_cuda

SOURCE = "flash_mla.cu"
# The tiles and the block (``BQ``, ``BK``, ``D_NOPE``, ``D_ROPE``, ``DV``,
# ``STAGES``, ``THREADS`` and ``SMEM_BYTES`` in the CUDA source).
TILE_Q, TILE_K = 128, 128
D_NOPE, D_ROPE, D_V = 128, 64, 128
STAGES, THREADS = 2, 384
# The query tile, two stages of key and value tiles, the barriers and 1 KB
# to align the tiles to the 128-byte swizzle's 1024-byte pattern.
SMEM_BYTES = (3 + STAGES * 5) * 128 * 128 + 128 + 1024

BF16, F32 = torch.bfloat16, torch.float32
_P, _I, _F, _L = _build.PTR, _build.INT, _build.FLOAT, ctypes.c_longlong
# Each operand part (q_nope, q_rope, k_nope, k_rope, v): its pointer and
# element strides over batch, position and head (k_rope, shared by every
# head, has none); then out, out_f32, B, S, H, scale and the stream.
KERNEL = _build.CudaKernel(SOURCE, "flash_mla_prefill",
                           [_P, _L, _L, _L] * 3 + [_P, _L, _L]
                           + [_P, _L, _L, _L] + [_P] + [_I] * 4
                           + [_F, _P])

Pair = tuple[torch.Tensor, torch.Tensor]


def _shapes(q: Pair, k: Pair, v: torch.Tensor) -> tuple[int, int, int]:
    """(B, S, H) of MLA's operands, or a ValueError naming the one that
    does not fit."""
    if not (isinstance(q, tuple) and isinstance(k, tuple)
            and len(q) == len(k) == 2):
        raise ValueError("q and k must be their (nope, rope) parts")
    (q_nope, q_rope), (k_nope, k_rope) = q, k
    B, S, H = q_nope.shape[:3]
    if S < 1:
        raise ValueError("flash_prefill needs at least one position")
    want = {"q_nope": (q_nope, (B, S, H, D_NOPE)),
            "q_rope": (q_rope, (B, S, H, D_ROPE)),
            "k_nope": (k_nope, (B, S, H, D_NOPE)),
            "k_rope": (k_rope, (B, S, D_ROPE)),
            "v": (v, (B, S, H, D_V))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {shape}, got {tuple(t.shape)}: flash_prefill "
                f"is causal self-attention in MLA's layout (the rope key one "
                f"head shared by all, keys as long as the queries)")
    return B, S, H


def causal_work(S: int, H: int, B: int) -> tuple[float, float]:
    """(FLOPs, bytes) the causal attention needs: 2 (192 + 128) FLOPs a
    visible (query, key) pair; q (192 dims a head), k_nope and v (128
    each) read once, the shared rope key (64) once, the bf16 output (128)
    written once; the least work whatever the tiles."""
    pairs = S * (S + 1) // 2
    flops = 2.0 * (D_NOPE + D_ROPE + D_V) * pairs * H * B
    bytes_ = 2.0 * B * S * (H * (D_NOPE + D_ROPE + D_V)
                            + H * (D_NOPE + D_V) + D_ROPE)
    return flops, bytes_


def flash_prefill_ref(q: Pair, k: Pair, v: torch.Tensor, *, scale: float,
                      out_dtype: torch.dtype = BF16) -> torch.Tensor:
    """The plain version: the kernel's tiles, skips and rounding points in
    PyTorch (f32 from bf16 operands)."""
    B, S, H = _shapes(q, k, v)
    (q_nope, q_rope), (k_nope, k_rope) = q, k
    qw = torch.cat([q_nope, q_rope.to(q_nope.dtype)], dim=-1)
    kw = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, D_ROPE).to(k_nope.dtype)], dim=-1)
    n = -(-S // TILE_Q)
    qp, kp, vp = (_pad(x, n * TILE_Q).to(BF16).to(F32) for x in (qw, kw, v))
    outs = [_tile_rows(qp[:, i * TILE_Q:(i + 1) * TILE_Q], kp, vp, scale, i)
            for i in range(n)]
    return torch.cat(outs, dim=1)[:, :S].to(out_dtype)


def _pad(x: torch.Tensor, length: int) -> torch.Tensor:
    pad = length - x.shape[1]
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])],
                     dim=1) if pad else x


def _tile_rows(qc: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
               scale: float, i: int) -> torch.Tensor:
    """Query tile ``i``, qc (B, 128, H, 192), through the online softmax
    over key tiles 0..i -> (B, 128, H, 128) f32; on the diagonal tile a
    key past a row's position is masked (every row sees key 0, so the
    running max is finite from the first tile on)."""
    B, cq, H, _ = qc.shape
    dev = qc.device
    m = torch.full((B, H, cq), -math.inf, dtype=F32, device=dev)
    l = torch.zeros((B, H, cq), dtype=F32, device=dev)
    acc = torch.zeros((B, H, cq, vp.shape[-1]), dtype=F32, device=dev)
    above = (torch.arange(TILE_K, device=dev)[None, :]
             > torch.arange(cq, device=dev)[:, None])
    for j in range(i + 1):
        kc = kp[:, j * TILE_K:(j + 1) * TILE_K]
        vc = vp[:, j * TILE_K:(j + 1) * TILE_K]
        logits = torch.einsum("bqhd,bkhd->bhqk", qc, kc) * scale
        if j == i:
            logits = logits.masked_fill(above, -math.inf)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = (acc * corr[..., None]
               + torch.einsum("bhqk,bkhd->bhqd", p.to(BF16).to(F32), vc))
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2)


def _check(t: torch.Tensor, name: str) -> None:
    if t.dtype != BF16:
        raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous along its last dim")
    if t.data_ptr() % 16 or any(s % 8 for n, s in zip(t.shape[:-1],
                                                      t.stride()[:-1])
                                if n > 1):
        raise ValueError(f"{name}'s base and strides must be 16-byte "
                         f"aligned (a tensor map's rule)")


def _strides(t: torch.Tensor) -> list[int]:
    """Element strides over (batch, position[, head])."""
    return list(t.stride()[:-1])


def flash_prefill(q: Pair, k: Pair, v: torch.Tensor, *, scale: float,
                  out_dtype: torch.dtype = BF16) -> torch.Tensor:
    """Causal self-attention of q over k, v in MLA's layout -> (B, S, H,
    128) in ``out_dtype``; see the module's note."""
    B, S, H = _shapes(q, k, v)
    (q_nope, q_rope), (k_nope, k_rope) = q, k
    if not on_cuda(q_nope, q_rope, k_nope, k_rope, v):
        return flash_prefill_ref(q, k, v, scale=scale, out_dtype=out_dtype)
    if out_dtype not in (BF16, F32):
        raise TypeError(f"out_dtype must be bfloat16 or float32, got "
                        f"{out_dtype}")
    for name, t in (("q_nope", q_nope), ("q_rope", q_rope),
                    ("k_nope", k_nope), ("k_rope", k_rope), ("v", v)):
        _check(t, name)
    tracing.add("attn.kernel_calls", 1)
    out = torch.empty((B, S, H, D_V), dtype=out_dtype, device=v.device)
    args = []
    for t in (q_nope, q_rope, k_nope, k_rope, v):
        args += [t.data_ptr(), *_strides(t)]
    KERNEL(*args, out.data_ptr(), int(out_dtype == F32), B, S, H,
           float(scale), torch.cuda.current_stream().cuda_stream)
    return out

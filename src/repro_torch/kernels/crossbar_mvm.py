"""Analog crossbar matrix-vector product: the wrapper of the CUDA kernel in
``csrc/crossbar_mvm.cu`` (the port of ``repro.kernels.crossbar_mvm``).

``crossbar_mvm(drive, g)`` returns ``drive @ (g * v_read * nl(g))`` with
the Y-Flash low-conductance read nonlinearity.  Tensors on the CPU go to
the plain version (``ref.crossbar_mvm_ref``); tensors on a CUDA device go
to the kernel, or the call raises.

The launch is planned here, once per ``(B, K, N, SM count)``: the narrow
path for N < 16, else 64 x 64 output tiles with the contraction split so
that about one wave of blocks runs.  The copy width of each operand (16
or 4 bytes) is chosen per call from its pointer and row stride.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import _build
from .ref import crossbar_mvm_ref

# The tile shape and limits of ``csrc/crossbar_mvm.cu``.
TILE_B, TILE_N, STAGE_K = 64, 64, 16
NARROW_MAX_N, NARROW_MAX_LANES = 15, 4
MIN_SPLIT_STAGES = 4
# Blocks an SM runs at once, on either path (256 threads and up to 100
# registers each; 27 KB of shared memory a tile block): a wave is this
# many per SM.  ``analysis.smem`` checks it against the registers and
# shared memory each compiled kernel reports.
BLOCKS_PER_SM = 2
# The kernels' blocks: threads of a tile block (a 4 x 4 register tile a
# thread), its copy ring's depth and the padding of a drive row in
# shared memory; threads of a narrow block and of a reduce block.
THREADS, STAGES, APAD = 256, 3, STAGE_K + 4
NARROW_THREADS, REDUCE_THREADS = 256, 256

TILES, NARROW = 0, 1

KERNEL = _build.CudaKernel(
    "crossbar_mvm.cu", "crossbar_mvm_f32",
    [_build.PTR] * 4 + [_build.INT] * 3 + [_build.FLOAT] * 3
    + [_build.INT] * 6 + [_build.PTR])


@dataclass(frozen=True)
class Plan:
    """How one ``(B, K, N)`` call runs: ``path`` (``TILES`` or ``NARROW``),
    the contraction split into ``splits`` chunks of ``chunk`` rows (the
    last one ragged), ``lanes`` batch lanes per narrow block, and the
    number of ``blocks`` the main launch has."""
    path: int
    splits: int
    chunk: int
    lanes: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def plan(B: int, K: int, N: int, sms: int) -> Plan:
    """The launch plan of a ``(B, K, N)`` product on a card with ``sms``
    streaming multiprocessors."""
    wave = BLOCKS_PER_SM * sms
    if N <= NARROW_MAX_N:
        lanes = min(NARROW_MAX_LANES, max(1, _cdiv(B, wave)))
        return Plan(NARROW, 1, max(K, 1), lanes, _cdiv(B, lanes))
    tiles = _cdiv(B, TILE_B) * _cdiv(N, TILE_N)
    stages = max(1, _cdiv(K, STAGE_K))
    # At most one wave, and splits deep enough to fill the copy ring; no
    # lanes (B = 0), no tiles and one split.
    want = (max(1, min(wave // tiles, stages // MIN_SPLIT_STAGES))
            if tiles else 1)
    chunk = _cdiv(stages, want) * STAGE_K
    splits = max(1, _cdiv(K, chunk))
    return Plan(TILES, splits, chunk, 1, tiles * splits)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def copy_widths(drive: torch.Tensor, g: torch.Tensor) -> tuple[int, int]:
    """Bytes a ``cp.async`` of each contiguous operand may move at once:
    16 where its base pointer and row stride are 16-byte aligned, else 4."""
    return tuple(16 if t.data_ptr() % 16 == 0 and t.shape[1] % 4 == 0 else 4
                 for t in (drive, g))


def describe(drive: torch.Tensor, g: torch.Tensor) -> str:
    """The path a CUDA call on these operands takes, in words."""
    (B, K), N = drive.shape, g.shape[1]
    p = plan(B, K, N, sm_count(drive.device.index))
    if p.path == NARROW:
        return f"narrow, {p.lanes} lane(s) a block, {p.blocks} blocks"
    wa, wb = copy_widths(drive, g)
    return (f"64x64 tiles, copies {wa}/{wb} B (drive/g), {p.splits} "
            f"split(s) of {p.chunk} rows, {p.blocks} blocks")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the current CUDA device, False when
    every one lies on the CPU; raises on anything else."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        cur = torch.cuda.current_device()
        if any(t.device.index != cur for t in tensors):
            raise ValueError("kernel operands must lie on the current CUDA "
                             f"device (cuda:{cur})")
        return True
    raise ValueError(f"kernel operands must all lie on the CPU or all on "
                     f"one CUDA device, got {sorted(kinds)}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` has the kernel's dtype, rank and a contiguous
    layout."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def byte_view(t: torch.Tensor, name: str) -> torch.Tensor:
    """A bool / int8 / uint8 operand as contiguous bytes (a view when it
    is contiguous already)."""
    if t.dtype not in (torch.bool, torch.int8, torch.uint8):
        raise TypeError(f"{name} must be bool, int8 or uint8, got {t.dtype}")
    return t.contiguous().view(torch.uint8)


def bool_bytes(t: torch.Tensor, name: str) -> torch.Tensor:
    """A bool / int8 / uint8 mask as contiguous bytes of 0 or 1 (a view of
    a contiguous bool tensor, else a copy)."""
    b = byte_view(t, name)
    return b if t.dtype == torch.bool else (b != 0).view(torch.uint8)


@_build.primitive(KERNEL)
def crossbar_mvm(drive: torch.Tensor, g: torch.Tensor, *,
                 v_read: float = 2.0, nonlin: float = 1.5,
                 cutoff: float = 10e-9) -> torch.Tensor:
    """drive (B, K) f32 row voltages (in V_R units), g (K, N) f32
    conductances -> column currents (B, N) f32."""
    if not on_cuda(drive, g):
        return crossbar_mvm_ref(drive, g, v_read=v_read, nonlin=nonlin,
                                cutoff=cutoff)
    check(drive, "drive", torch.float32, 2)
    check(g, "g", torch.float32, 2)
    B, K = drive.shape
    K2, N = g.shape
    if K != K2:
        raise ValueError(f"drive has {K} rows to drive, g has {K2}")
    if B == 0:
        return torch.empty((0, N), dtype=torch.float32, device=drive.device)
    p = plan(B, K, N, sm_count(drive.device.index))
    vec_a, vec_b = (int(w == 16) for w in copy_widths(drive, g))
    out = torch.empty((B, N), dtype=torch.float32, device=drive.device)
    scratch = (torch.empty((p.splits, B, N), dtype=torch.float32,
                           device=drive.device) if p.splits > 1 else None)
    KERNEL(drive.data_ptr(), g.data_ptr(), out.data_ptr(),
           None if scratch is None else scratch.data_ptr(), B, K, N,
           v_read, nonlin, cutoff, p.path, vec_a, vec_b, p.splits, p.chunk,
           p.lanes, torch.cuda.current_stream().cuda_stream)
    return out

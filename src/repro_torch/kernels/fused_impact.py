"""Fused analog IMPACT inference: the wrappers of the CUDA kernels in
``csrc/fused_impact.cu`` (the port of ``repro.kernels.fused_impact``'s
``fused_impact``, ``fused_impact_metered``, ``fused_impact_packed`` and
``fused_impact_packed_metered``).

All take the programmed system's own layouts: literals (B, K) int8,
nonempty (C*tc,) bool, class_i (S, sr, M) f32, and the clause cells as
clause_i (R, C, tr, tc) f32 or, for the packed kernels, as the 2-bit
operand of ``kernels.packing`` (bits (R, C, ceil(tr/4), tc) uint8 and
levels (2,) f32, with ``tr`` given).  The plain kernels return the class
currents (B, M); the metered ones also return the per-lane summed
clause-crossbar and class-crossbar column currents, each (B,).  Tensors
on the CPU go to the plain versions in ``ref``; tensors on a CUDA device
go to the kernel, or the call raises.  One wrapper call is one launch of
the kernel (its two passes on the current stream), and the wrapper
allocates the kernel's scratch.

The launch is planned here, once per shape and SM count (``plan``): the
pass-1 tile, the split of each shard's live rows into chunks of whole
stages for about one wave of blocks, and the tail's warps a lane and
lanes a block.  The copy widths of the literals, the f32 clause currents
and the packed codes, and the tail's load width, are chosen per call from
their pointers and strides (``copy_widths``, ``code_width``,
``tail_width``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import _build
from .crossbar_mvm import check, on_cuda, sm_count
from .packing import packed_rows
from .ref import (fused_impact_metered_ref, fused_impact_packed_metered_ref,
                  fused_impact_packed_ref, fused_impact_ref)

SOURCE = "fused_impact.cu"
_P, _I, _F = _build.PTR, _build.INT, _build.FLOAT
# B, K, R, C, tr, tc, Nc, M, thresh
_SHAPE_ARGS = [_I] * 8 + [_F]
# lit_width, vec_c (code_width when packed), splits, chunk, the tail's warps
# a lane, lanes a block and load width; then the stream
_PLAN = [_I] * 7 + [_P]

KERNEL = _build.CudaKernel(SOURCE, "fused_impact_f32",
                           [_P] * 6 + _SHAPE_ARGS + _PLAN)
KERNEL_METERED = _build.CudaKernel(
    SOURCE, "fused_impact_metered_f32", [_P] * 8 + _SHAPE_ARGS + _PLAN)
KERNEL_PACKED = _build.CudaKernel(
    SOURCE, "fused_impact_packed_f32", [_P] * 7 + _SHAPE_ARGS + _PLAN)
KERNEL_PACKED_METERED = _build.CudaKernel(
    SOURCE, "fused_impact_packed_metered_f32",
    [_P] * 9 + _SHAPE_ARGS + _PLAN)

# Pass 1's tile (lanes, clause columns, rows a stage), of
# ``impact_tiles`` on f32 cells and ``packed_tiles`` on 2-bit codes.
F32_TILE = (64, 64, 16)
# Chunks are at least this many stages deep, to fill the copy ring.
MIN_SPLIT_STAGES = 4
# Blocks an SM runs at once: a wave of the f32 pass 1 is this many per
# SM ...
BLOCKS_PER_SM = 2
# ... and of the packed pass 1 (``PACKED_BLOCKS`` in the CUDA source),
# measured on its own: three an SM (20 chunks of 80 rows at the paper
# shape) made rows 4-5 slower than two (PERF.md, findings).
PACKED_BLOCKS_PER_SM = 2
# The tail (``TAIL_THREADS``, ``TAIL_BLOCKS``, ``FIRED_WORDS``, ``MT`` and
# ``LIST`` in the CUDA source): threads a block at most, blocks an SM its
# wave is planned for (32 warps; its registers are capped to fit them),
# the shared-memory words of the fired bits of a block's lanes (so at
# most 65,536 clause columns a lane), the classes of one pass of its class
# stage (a warp's f64 partial sums in shared memory) and the entries of a
# warp's list of fired columns (those of 32 words).
TAIL_THREADS, TAIL_BLOCKS_PER_SM, TAIL_FIRED_WORDS = 256, 4, 2048
TAIL_CLASSES, TAIL_LIST = 32, 1024
# Pass 1's block: threads (a 4 x 4 register tile a thread) and its copy
# ring's depth.
THREADS, STAGES = 256, 3


@dataclass(frozen=True)
class Plan:
    """How one call runs: pass 1 in tiles of ``tile_b`` lanes x
    ``tile_n`` clause columns with ``stage`` rows a stage, the live rows
    of each shard in ``splits`` chunks of ``chunk`` rows (whole stages,
    the last one ragged), ``blocks`` pass-1 blocks; the tail in
    ``tail_blocks`` blocks of ``lanes`` lanes, each lane streamed by
    ``tail_warps`` warps."""
    tile_b: int
    tile_n: int
    stage: int
    splits: int
    chunk: int
    blocks: int
    tail_warps: int
    lanes: int
    tail_blocks: int

    @property
    def tail_threads(self) -> int:
        """Threads of a tail block."""
        return 32 * self.tail_warps * self.lanes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def plan(B: int, K: int, R: int, C: int, tr: int, tc: int, sms: int,
         packed: bool = False) -> Plan:
    """The launch plan of a call on literals (B, K) and a clause grid
    (R, C, tr, tc) on a card with ``sms`` streaming multiprocessors.

    Pass 1 takes about one wave of blocks (``BLOCKS_PER_SM`` an SM on f32
    cells, ``PACKED_BLOCKS_PER_SM`` on packed ones), with chunks deep
    enough to fill the copy ring.  The tail gives a lane as many warps as
    a wave of ``TAIL_BLOCKS_PER_SM`` full blocks an SM holds for B lanes
    (at most a block's, and no more threads than the lane has 16-byte
    column groups), then puts as many lanes in a block as fit its
    threads and fired words while the blocks still cover every SM.
    Raises ``ValueError`` past 65,536 clause columns."""
    tile_b, tile_n, stage = F32_TILE
    live = max(0, min(tr, K))            # live rows of the fullest shard
    stages = _cdiv(live, stage)
    tiles = _cdiv(B, tile_b) * C * _cdiv(tc, tile_n) * R
    wave = (PACKED_BLOCKS_PER_SM if packed else BLOCKS_PER_SM) * sms
    want = 1
    if tiles and stages:
        want = max(1, min(wave // tiles, stages // MIN_SPLIT_STAGES))
    chunk = max(1, _cdiv(stages, want)) * stage
    splits = max(1, _cdiv(live, chunk))
    words = _cdiv(C * tc, 32)
    if words > TAIL_FIRED_WORDS:
        raise ValueError(f"{C * tc} clause columns: the kernel takes at "
                         f"most {32 * TAIL_FIRED_WORDS}")
    block_warps = TAIL_THREADS // 32
    tail_wave = TAIL_BLOCKS_PER_SM * sms * block_warps   # warps
    groups = _cdiv(C * tc, 4)
    warps = 1
    while (2 * warps <= block_warps and 2 * warps * B <= tail_wave
           and 64 * warps <= groups):
        warps *= 2
    lanes = 1
    while (2 * lanes * warps <= block_warps
           and 2 * lanes * words <= TAIL_FIRED_WORDS
           and _cdiv(B, 2 * lanes) >= sms):
        lanes *= 2
    return Plan(tile_b, tile_n, stage, splits, chunk, tiles * splits, warps,
                lanes, _cdiv(B, lanes))


def copy_widths(literals: torch.Tensor, clause_i: torch.Tensor, R: int,
                tr: int) -> tuple[int, int]:
    """Bytes a copy of each contiguous operand may move at once: the
    literals 16 where their base pointer, row stride K and (with several
    row shards) the shard start r*tr are multiples of 16, else 1 (plain
    loads); the f32 clause currents 16 where their base pointer is
    16-byte aligned and tc % 4 == 0, else 4."""
    K, ptr = literals.shape[1], literals.data_ptr()
    lit = 16 if ptr % 16 == 0 and K % 16 == 0 and (R == 1 or tr % 16 == 0) \
        else 1
    vec = clause_i.data_ptr() % 16 == 0 and clause_i.shape[-1] % 4 == 0
    return lit, 16 if vec else 4


def tail_width(part: torch.Tensor, N: int) -> int:
    """Floats a load of the tail reads from the partials ``part`` (R *
    splits, B, N) at once: 4 (16 bytes) where N % 4 == 0 and the base is
    16-byte aligned, else 1 (plain loads)."""
    return 4 if N % 4 == 0 and part.data_ptr() % 16 == 0 else 1


def code_width(bits: torch.Tensor) -> int:
    """Bytes a copy of the contiguous packed codes (R, C, tr4, tc) moves
    at once: 4 where their base pointer and tc are multiples of 4, else 1
    (plain loads).  There are no 16-byte code copies: the 16 threads
    that would copy a stage would decode 64 cells each while the block
    waits, which measured slower (PERF.md, findings)."""
    return 4 if bits.data_ptr() % 4 == 0 and bits.shape[-1] % 4 == 0 else 1


def describe(literals: torch.Tensor, cells: torch.Tensor,
             tr: int | None = None) -> str:
    """The path a CUDA call on these operands takes, in words:
    ``fused_impact``'s on clause_i (R, C, tr, tc), or with ``tr`` given,
    ``fused_impact_packed``'s on the packed codes (R, C, tr4, tc)."""
    B, K = literals.shape
    R, C = cells.shape[:2]
    tc = cells.shape[-1]
    packed = tr is not None
    if not packed:
        tr = cells.shape[2]
    p = plan(B, K, R, C, tr, tc, sm_count(literals.device.index), packed)
    lit, width = copy_widths(literals, cells, R, tr)
    if packed:
        width = code_width(cells)
    what = "codes" if packed else "cells"
    how = lambda w: f"{w}-byte copies" if w > 1 else "plain loads"
    return (f"{p.tile_b}x{p.tile_n} tiles, literals by {how(lit)}, {what} "
            f"by {how(width)}, {p.splits} chunk(s) of {p.chunk} rows a "
            f"shard, {p.blocks} blocks; tail {p.tail_blocks} blocks of "
            f"{p.lanes} lane(s), {p.tail_warps} warp(s) a lane")


def _operands(literals, nonempty, class_i, grid):
    """Validate the operands around the clause cells of a ``grid`` =
    (R, C, tr, tc) -> (nonempty as bytes, the shape arguments)."""
    check(literals, "literals", torch.int8, 2)
    check(class_i, "class_i", torch.float32, 3)
    B, K = literals.shape
    R, C, tr, tc = grid
    S, sr, M = class_i.shape
    if R * tr < K:
        raise ValueError(f"the clause grid holds {R}x{tr} rows for {K} "
                         f"literals")
    if nonempty.shape != (C * tc,) or nonempty.dtype not in (
            torch.bool, torch.uint8):
        raise ValueError(f"nonempty must be bool ({C * tc},), got "
                         f"{nonempty.dtype} {tuple(nonempty.shape)}")
    return (nonempty.contiguous().view(torch.uint8),
            (B, K, R, C, tr, tc, S * sr, M))


def _packed_cells(bits, levels, tr):
    """Check the packed clause operand -> (its tensors, the grid)."""
    check(bits, "bits", torch.uint8, 4)
    check(levels, "levels", torch.float32, 1)
    R, C, tr4, tc = bits.shape
    if tr4 != packed_rows(tr) or levels.shape != (2,):
        raise ValueError(f"bits {tuple(bits.shape)} and levels "
                         f"{tuple(levels.shape)} do not pack {tr} rows a "
                         f"shard with two levels")
    return (bits, levels), (R, C, tr, tc)


def _launch(kernel, literals, cells, nonempty, class_i, grid, *,
            thresh: float, metered: bool, packed: bool):
    """Plan, allocate the scratch and the outputs and launch ``kernel``
    once on the checked clause tensors ``cells`` -> the scores, or
    (scores, clause meter, class meter)."""
    ne, shape = _operands(literals, nonempty, class_i, grid)
    B, K, R, C, tr, tc, _, M = shape
    dev = literals.device
    outs = [torch.empty((B, M), dtype=torch.float32, device=dev)]
    if metered:
        outs += [torch.empty((B,), dtype=torch.float32, device=dev)
                 for _ in range(2)]
    if B == 0:
        return tuple(outs) if metered else outs[0]
    p = plan(B, K, R, C, tr, tc, sm_count(dev.index), packed)
    lit, cl = copy_widths(literals, cells[0], R, tr)
    width = code_width(cells[0]) if packed else int(cl == 16)
    part = torch.empty((R * p.splits * B * C * tc,), dtype=torch.float32,
                       device=dev)
    plan_args = (lit, width, p.splits, p.chunk, p.tail_warps, p.lanes,
                 tail_width(part, C * tc))
    kernel(literals.data_ptr(), *(t.data_ptr() for t in cells),
           ne.data_ptr(), class_i.data_ptr(), part.data_ptr(),
           *(t.data_ptr() for t in outs), *shape, thresh, *plan_args,
           torch.cuda.current_stream().cuda_stream)
    return tuple(outs) if metered else outs[0]


@_build.primitive(KERNEL)
def fused_impact(literals: torch.Tensor, clause_i: torch.Tensor,
                 nonempty: torch.Tensor, class_i: torch.Tensor, *,
                 thresh: float) -> torch.Tensor:
    """-> class currents (B, M) f32 (argmax = prediction)."""
    if not on_cuda(literals, clause_i, nonempty, class_i):
        return fused_impact_ref(literals, clause_i, nonempty, class_i,
                                thresh=thresh)
    check(clause_i, "clause_i", torch.float32, 4)
    return _launch(KERNEL, literals, (clause_i,), nonempty, class_i,
                   clause_i.shape, thresh=thresh, metered=False,
                   packed=False)


@_build.primitive(KERNEL_METERED)
def fused_impact_metered(literals: torch.Tensor, clause_i: torch.Tensor,
                         nonempty: torch.Tensor, class_i: torch.Tensor, *,
                         thresh: float,
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (scores (B, M), per-lane clause meter (B,), per-lane class meter
    (B,)), the meters in amperes (``impact.energy.per_lane_read_energy``
    turns them into joules)."""
    if not on_cuda(literals, clause_i, nonempty, class_i):
        return fused_impact_metered_ref(literals, clause_i, nonempty,
                                        class_i, thresh=thresh)
    check(clause_i, "clause_i", torch.float32, 4)
    return _launch(KERNEL_METERED, literals, (clause_i,), nonempty, class_i,
                   clause_i.shape, thresh=thresh, metered=True, packed=False)


@_build.primitive(KERNEL_PACKED)
def fused_impact_packed(literals: torch.Tensor, bits: torch.Tensor,
                        levels: torch.Tensor, nonempty: torch.Tensor,
                        class_i: torch.Tensor, *, thresh: float,
                        tr: int) -> torch.Tensor:
    """``fused_impact`` on the packed clause operand (``bits`` (R, C,
    ceil(tr/4), tc) uint8, ``levels`` (2,) f32, ``tr`` the unpacked rows
    of a shard) -> class currents (B, M) f32.  The kernel unpacks the
    codes into its shared-memory stages."""
    if not on_cuda(literals, bits, levels, nonempty, class_i):
        return fused_impact_packed_ref(literals, bits, levels, nonempty,
                                       class_i, thresh=thresh, tr=tr)
    cells, grid = _packed_cells(bits, levels, tr)
    return _launch(KERNEL_PACKED, literals, cells, nonempty, class_i, grid,
                   thresh=thresh, metered=False, packed=True)


@_build.primitive(KERNEL_PACKED_METERED)
def fused_impact_packed_metered(literals: torch.Tensor, bits: torch.Tensor,
                                levels: torch.Tensor, nonempty: torch.Tensor,
                                class_i: torch.Tensor, *, thresh: float,
                                tr: int,
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """``fused_impact_metered`` on the packed clause operand: the clause
    meter bills the quantized column currents."""
    if not on_cuda(literals, bits, levels, nonempty, class_i):
        return fused_impact_packed_metered_ref(literals, bits, levels,
                                               nonempty, class_i,
                                               thresh=thresh, tr=tr)
    cells, grid = _packed_cells(bits, levels, tr)
    return _launch(KERNEL_PACKED_METERED, literals, cells, nonempty, class_i,
                   grid, thresh=thresh, metered=True, packed=True)

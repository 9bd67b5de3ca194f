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
stages for about one wave of blocks, and the tail's lanes a block.  The
copy widths of the literals and the f32 clause currents are chosen per
call from their pointers and strides (``copy_widths``).
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
_F32_PLAN = [_I] * 5 + [_P]        # lit_width, vec_c, splits, chunk, lanes
_PACKED_PLAN = [_I] * 3 + [_P]     # splits, chunk, lanes; then the stream

KERNEL = _build.CudaKernel(SOURCE, "fused_impact_f32",
                           [_P] * 6 + _SHAPE_ARGS + _F32_PLAN)
KERNEL_METERED = _build.CudaKernel(
    SOURCE, "fused_impact_metered_f32", [_P] * 8 + _SHAPE_ARGS + _F32_PLAN)
KERNEL_PACKED = _build.CudaKernel(
    SOURCE, "fused_impact_packed_f32", [_P] * 7 + _SHAPE_ARGS + _PACKED_PLAN)
KERNEL_PACKED_METERED = _build.CudaKernel(
    SOURCE, "fused_impact_packed_metered_f32",
    [_P] * 9 + _SHAPE_ARGS + _PACKED_PLAN)

# Pass 1's tiles (lanes, clause columns, rows a stage): ``impact_tiles``
# on f32 cells, ``column_currents<PackedCells>`` (``tile_mma.cuh``) on
# packed ones.
F32_TILE = (64, 64, 16)
PACKED_TILE = (32, 32, 32)
# f32 chunks are at least this many stages deep, to fill the copy ring.
MIN_SPLIT_STAGES = 4
# Blocks an SM runs at once: a wave is this many per SM.
BLOCKS_PER_SM = 2
# The tail: lanes a block, and the shared-memory words of their fired
# bits (so at most 65,536 clause columns a lane).
TAIL_MAX_LANES, TAIL_FIRED_WORDS = 4, 2048


@dataclass(frozen=True)
class Plan:
    """How one call runs: pass 1 in tiles of ``tile_b`` lanes x
    ``tile_n`` clause columns with ``stage`` rows a stage, the live rows
    of each shard in ``splits`` chunks of ``chunk`` rows (whole stages,
    the last one ragged), ``blocks`` pass-1 blocks; the tail in
    ``tail_blocks`` blocks of ``lanes`` lanes."""
    tile_b: int
    tile_n: int
    stage: int
    splits: int
    chunk: int
    blocks: int
    lanes: int
    tail_blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def plan(B: int, K: int, R: int, C: int, tr: int, tc: int, sms: int,
         packed: bool = False) -> Plan:
    """The launch plan of a call on literals (B, K) and a clause grid
    (R, C, tr, tc) on a card with ``sms`` streaming multiprocessors.

    f32 cells: about one wave of blocks, with chunks deep enough to fill
    the copy ring.  Packed cells: the split the packed kernels have
    always run (ceil(wave / tiles) chunks, as few as whole stages allow).
    Raises ``ValueError`` past 65,536 clause columns."""
    wave = BLOCKS_PER_SM * sms
    tile_b, tile_n, stage = PACKED_TILE if packed else F32_TILE
    live = max(0, min(tr, K))            # live rows of the fullest shard
    stages = _cdiv(live, stage)
    tiles = _cdiv(B, tile_b) * C * _cdiv(tc, tile_n) * R
    if not tiles or not stages:
        want = 1
    elif packed:
        want = min(max(1, _cdiv(wave, tiles)), stages)
    else:
        want = max(1, min(wave // tiles, stages // MIN_SPLIT_STAGES))
    chunk = max(1, _cdiv(stages, want)) * stage
    splits = max(1, _cdiv(live, chunk))
    words = _cdiv(C * tc, 32)
    if words > TAIL_FIRED_WORDS:
        raise ValueError(f"{C * tc} clause columns: the kernel takes at "
                         f"most {32 * TAIL_FIRED_WORDS}")
    lanes = min(TAIL_MAX_LANES, max(1, _cdiv(B, wave)))
    lanes = 1 << (lanes.bit_length() - 1)          # 1, 2 or 4
    while lanes > 1 and lanes * words > TAIL_FIRED_WORDS:
        lanes //= 2
    return Plan(tile_b, tile_n, stage, splits, chunk, tiles * splits, lanes,
                _cdiv(B, lanes))


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


def describe(literals: torch.Tensor, clause_i: torch.Tensor) -> str:
    """The path a CUDA call of ``fused_impact`` on these operands takes,
    in words."""
    B, K = literals.shape
    R, C, tr, tc = clause_i.shape
    p = plan(B, K, R, C, tr, tc, sm_count(literals.device.index))
    lit, cl = copy_widths(literals, clause_i, R, tr)
    lits = f"{lit}-byte copies" if lit > 1 else "plain loads"
    return (f"{p.tile_b}x{p.tile_n} tiles, literals by {lits}, cells by "
            f"{cl}-byte copies, {p.splits} chunk(s) of {p.chunk} rows a "
            f"shard, {p.blocks} blocks; tail {p.tail_blocks} blocks of "
            f"{p.lanes} lane(s)")


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
    if packed:
        plan_args = (p.splits, p.chunk, p.lanes)
    else:
        lit, cl = copy_widths(literals, cells[0], R, tr)
        plan_args = (lit, int(cl == 16), p.splits, p.chunk, p.lanes)
    part = torch.empty((R * p.splits * B * C * tc,), dtype=torch.float32,
                       device=dev)
    kernel(literals.data_ptr(), *(t.data_ptr() for t in cells),
           ne.data_ptr(), class_i.data_ptr(), part.data_ptr(),
           *(t.data_ptr() for t in outs), *shape, thresh, *plan_args,
           torch.cuda.current_stream().cuda_stream)
    return tuple(outs) if metered else outs[0]


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

"""2-bit packing of the ternary clause crossbar (the port of
``repro.kernels.packing``).

At the device abstraction a clause-crossbar cell is ternary: an include
(HCS), an exclude (LCS, leakage only) or no device at all (pruned or
padding, no current).  The packed operand stores one 2-bit code per cell,
four cells per byte along the literal-row (contraction) axis, plus two
f32 levels ``[i_lcs, i_hcs]``: 16x fewer clause bytes than the f32 read
currents.

Layout contract (shared by the CUDA kernels in ``csrc/fused_impact.cu``,
the plain versions in ``ref`` and the reference): bit-field ``j`` (shift
``2*j``) of packed row ``q`` holds the code of cell row ``4*q + j``; rows
past the last cell row pad with ``CODE_DEAD``.  Codes:

* ``CODE_DEAD = 0``: no device, pruned or padding; 0 A.
* ``CODE_LCS = 1``: exclude cell; dequantizes to the mean LCS current.
* ``CODE_HCS = 2``: include cell; dequantizes to the mean HCS current.
* ``3`` is reserved.

Cells are split into HCS and LCS at the geometric midpoint of the
smallest and largest positive currents (``population_split``), which
lands in the decades-wide gap between the two device populations; the
CSA threshold is not the split, because a far-tail HCS cell just below
it would bin as LCS.  Packing is lossless on ideal devices, where every
HCS and every LCS cell carries the same current; with device
variability each cell's current becomes its population's mean, and the
column currents stay far from the CSA threshold.

Parity with the reference: ``bits`` and ``population_split`` are bit
for bit the reference's (a max, a min and a correctly rounded ``sqrt``
of an f32 product).  ``quant_levels`` sums in f64 and rounds the mean to
f32 once: the tests hold the levels bit for bit to the f64 mean of the
reference's codes, rounded once.  The reference sums in f32 in XLA's
order, which lands up to 1.4e-6 relative off that mean at the tests'
sizes, so against the reference's own levels the tests hold rtol 1e-5.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..numerics import sqrt_rn

CODE_DEAD = 0
CODE_LCS = 1
CODE_HCS = 2
CELLS_PER_BYTE = 4
_CODE_BITS = 2
_CODE_MASK = (1 << _CODE_BITS) - 1


class PackedClause(NamedTuple):
    """A packed clause crossbar: ``bits`` (R, C, ceil(tr/4), tc) uint8
    codes and ``levels`` (2,) f32 ``[i_lcs, i_hcs]``, on one device."""

    bits: torch.Tensor
    levels: torch.Tensor


def packed_rows(n_rows: int) -> int:
    """Number of packed (byte) rows covering ``n_rows`` cell rows."""
    return -(-n_rows // CELLS_PER_BYTE)


def _pack_rows(codes: torch.Tensor, dim: int) -> torch.Tensor:
    """Pack the cell-row axis ``dim`` of a code tensor 4:1 into uint8,
    padding it with ``CODE_DEAD`` to a multiple of 4."""
    codes = codes.to(torch.uint8).movedim(dim, -1)
    n = codes.shape[-1]
    pad = packed_rows(n) * CELLS_PER_BYTE - n
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad), value=CODE_DEAD)
    planes = codes.reshape(*codes.shape[:-1], -1, CELLS_PER_BYTE)
    packed = torch.zeros(planes.shape[:-1], dtype=torch.uint8,
                         device=codes.device)
    for j in range(CELLS_PER_BYTE):
        packed |= planes[..., j] << (_CODE_BITS * j)
    return packed.movedim(-1, dim).contiguous()


def _unpack_rows(packed: torch.Tensor, dim: int,
                 n_rows: int) -> torch.Tensor:
    """Inverse of ``_pack_rows``: the first ``n_rows`` cell rows."""
    planes = [(packed >> (_CODE_BITS * j)) & _CODE_MASK
              for j in range(CELLS_PER_BYTE)]
    full = torch.stack(planes, dim=dim + 1).flatten(dim, dim + 1)
    return full.narrow(dim, 0, n_rows).to(torch.uint8)


def pack_ternary(codes: torch.Tensor) -> torch.Tensor:
    """Pack a ``(K, N)`` matrix of 2-bit codes into ``(ceil(K/4), N)``
    uint8; rows beyond K pad with ``CODE_DEAD``."""
    return _pack_rows(torch.as_tensor(codes), 0)


def unpack_ternary(packed: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Inverse of :func:`pack_ternary`: ``(K4, N)`` uint8 ->
    ``(n_rows, N)`` uint8 codes."""
    return _unpack_rows(torch.as_tensor(packed), 0, n_rows)


def population_split(currents: torch.Tensor) -> torch.Tensor:
    """Geometric midpoint of the smallest and largest positive currents,
    an f32 scalar.  A single-population operand gives its common value
    (everything classifies as HCS)."""
    currents = currents.to(torch.float32)
    hi = torch.clamp(currents.max(), min=0.0)
    lo = torch.where(currents > 0.0, currents, hi).min()
    return sqrt_rn(torch.clamp(hi, min=1e-30) * torch.clamp(lo, min=1e-30))


def classify_currents(currents: torch.Tensor, *,
                      split=None) -> torch.Tensor:
    """Ternary uint8 codes for per-cell read currents: ``<= 0`` A is
    DEAD, ``>= split`` HCS, anything between LCS.  ``split=None`` uses
    :func:`population_split`."""
    if split is None:
        split = population_split(currents)
    hcs = torch.where(currents >= split, CODE_HCS, CODE_LCS)
    return torch.where(currents <= 0.0, CODE_DEAD, hcs).to(torch.uint8)


def quant_levels(currents: torch.Tensor,
                 codes: torch.Tensor) -> torch.Tensor:
    """``[i_lcs, i_hcs]`` f32: each population's mean current (0.0 for an
    empty population), summed in f64 and rounded to f32 once."""
    cur = currents.to(torch.float64)

    def mean_of(code: int) -> torch.Tensor:
        mask = codes == code
        n = torch.clamp(mask.sum(), min=1).to(torch.float64)
        return torch.where(mask, cur, 0.0).sum() / n

    return torch.stack([mean_of(CODE_LCS),
                        mean_of(CODE_HCS)]).to(torch.float32)


def dequant_codes(codes: torch.Tensor,
                  levels: torch.Tensor) -> torch.Tensor:
    """Codes -> f32 currents through the two levels."""
    levels = levels.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=levels.device)
    return torch.where(codes == CODE_HCS, levels[1],
                       torch.where(codes == CODE_LCS, levels[0], zero))


def pack_clause_operand(clause_i: torch.Tensor, *,
                        split=None) -> PackedClause:
    """Pack an ``(R, C, tr, tc)`` clause-current operand: ``bits``
    ``(R, C, ceil(tr/4), tc)`` uint8 and the two levels, on the operand's
    device."""
    clause_i = clause_i.to(torch.float32)
    codes = classify_currents(clause_i, split=split)
    levels = quant_levels(clause_i, codes)
    return PackedClause(bits=_pack_rows(codes, 2), levels=levels)


def dequant_clause(bits: torch.Tensor, levels: torch.Tensor,
                   tr: int) -> torch.Tensor:
    """Unpack ``(R, C, tr4, tc)`` bits back to ``(R, C, tr, tc)`` f32
    currents."""
    return dequant_codes(_unpack_rows(bits, 2, tr), levels).contiguous()


def packed_nbytes(packed: PackedClause) -> int:
    """Bytes of the packed operand (codes + levels)."""
    return int(packed.bits.numel() * packed.bits.element_size()
               + packed.levels.numel() * packed.levels.element_size())

"""The launch plan of ``fused_impact.cu``, computed on the host.

``repro_torch.kernels.fused_impact.plan`` picks pass 1's tile, splits each
row shard's live rows (``min(tr, K - r*tr)``) into chunks of whole stages
and sizes the tail's blocks; the CUDA side only checks the plan, so its
properties are held here on the CPU with the SM count as a parameter, at
the shapes ``chip_smoke.py`` launches the kernels at and at edge cases:
every shard's live rows are covered once, the paper shape fills about
one wave, the packed plan is the split the packed kernels have always
run, and the copy widths follow the operands' pointers and strides.
"""
import importlib
import importlib.util
import pathlib

import pytest
import torch

fi = importlib.import_module("repro_torch.kernels.fused_impact")

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SMS = (132, 114)          # H100 SXM, H100 PCIe
# (B, K, R, C, tr, tc): chip_smoke's kernel shapes, then edge cases: no
# lanes, K below tr, a short last shard, a shard with no live row, no
# literal, a single lane, many lanes.
SHAPES = ([(B, K, R, C, tr, tc)
           for B, K, _, _, R, tr, C, tc, _, _ in chip_smoke.KERNEL_SHAPES]
          + [(0, 1568, 1, 1, 2048, 512), (4, 100, 1, 1, 2048, 512),
             (5, 210, 3, 1, 100, 40), (5, 150, 3, 1, 100, 8),
             (3, 0, 1, 1, 16, 20), (1, 1568, 1, 1, 2048, 512),
             (4096, 1568, 1, 1, 2048, 512), (130, 2048, 1, 2, 2048, 512)])


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,K,R,C,tr,tc", SHAPES)
def test_chunks_cover_each_shards_live_rows_once(B, K, R, C, tr, tc, sms,
                                                 packed):
    p = fi.plan(B, K, R, C, tr, tc, sms, packed)
    assert p.chunk > 0 and p.chunk % p.stage == 0       # whole stages
    for r in range(R):
        live = max(0, min(tr, K - r * tr))
        rows = [k for s in range(p.splits)
                for k in range(s * p.chunk, min(live, (s + 1) * p.chunk))]
        assert rows == list(range(live))                 # in order, once
    fullest = max(0, min(tr, K))
    assert p.splits == max(1, _cdiv(fullest, p.chunk))   # none empty
    tiles = _cdiv(B, p.tile_b) * C * _cdiv(tc, p.tile_n) * R
    assert p.blocks == tiles * p.splits
    if not packed and p.splits > 1:                      # fills the ring
        assert p.chunk >= fi.MIN_SPLIT_STAGES * p.stage


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,K,R,C,tr,tc", SHAPES)
def test_tail_lanes_fit_the_fired_bits(B, K, R, C, tr, tc, sms):
    for packed in (False, True):
        p = fi.plan(B, K, R, C, tr, tc, sms, packed)
        assert p.lanes in (1, 2, 4)
        assert p.lanes * _cdiv(C * tc, 32) <= fi.TAIL_FIRED_WORDS
        assert p.tail_blocks == _cdiv(B, p.lanes)


@pytest.mark.parametrize("sms", SMS)
def test_paper_shape_fills_about_one_wave(sms):
    """16 tiles of 64 x 64 (lanes x columns) at B = 128, split into 14
    chunks of 112 rows: 224 blocks, one wave at two blocks an SM."""
    p = fi.plan(128, 1568, 1, 1, 2048, 512, sms)
    wave = fi.BLOCKS_PER_SM * sms
    assert (p.tile_b, p.tile_n, p.stage) == fi.F32_TILE == (64, 64, 16)
    assert (p.splits, p.chunk, p.blocks) == (14, 112, 224)
    assert 0.75 * wave <= p.blocks <= wave
    assert (p.lanes, p.tail_blocks) == (1, 128)


def _packed_split(B, K, R, C, tr, tc, sms):
    """The split the packed entries' C++ planner computed before the plan
    moved to the host (``split_k`` over 32 x 32 tiles and 32-row stages,
    aimed at two blocks an SM) -> (slices, chunk)."""
    k = min(tr, K)
    tiles = C * _cdiv(tc, 32) * _cdiv(B, 32) * R
    if k <= 0 or tiles <= 0:
        return 1, 32
    stages = _cdiv(k, 32)
    want = min(max(1, _cdiv(2 * sms, tiles)), stages)
    chunk = _cdiv(stages, want) * 32
    return _cdiv(k, chunk), chunk


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,K,R,C,tr,tc", [s for s in SHAPES if s[0] > 0])
def test_packed_plan_is_the_split_it_always_ran(B, K, R, C, tr, tc, sms):
    p = fi.plan(B, K, R, C, tr, tc, sms, packed=True)
    assert (p.tile_b, p.tile_n, p.stage) == fi.PACKED_TILE == (32, 32, 32)
    assert (p.splits, p.chunk) == _packed_split(B, K, R, C, tr, tc, sms)


def test_packed_paper_shape_keeps_its_320_blocks():
    p = fi.plan(128, 1568, 1, 1, 2048, 512, 132, packed=True)
    assert (p.splits, p.chunk, p.blocks) == (5, 320, 320)


def test_edge_cases_plan_without_error():
    assert fi.plan(0, 1568, 1, 1, 2048, 512, 132).blocks == 0
    assert fi.plan(0, 1568, 1, 1, 2048, 512, 132).tail_blocks == 0
    short = fi.plan(5, 210, 3, 1, 100, 40, 132)      # shard 2: 10 rows
    assert short.splits * short.chunk >= 100
    p = fi.plan(5, 100, 1, 1, 2048, 512, 132)        # K < tr
    assert p.splits * p.chunk >= 100 > (p.splits - 1) * p.chunk


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,lanes", [(chip_smoke.N_CALIBRATION, 4),
                                     (300, 2), (chip_smoke.CAPACITY, 1)])
def test_chip_smoke_batches_plan_every_tail_lane_count(B, lanes, sms, packed):
    """chip_smoke's tail-lane check holds the kernels at the calibration
    batch and at 300 lanes, which must plan 4 and 2 lanes a tail block at
    the paper and the multi-shard layouts; the serving capacity plans 1."""
    for base in (0, 2):
        _, K, _, _, R, tr, C, tc, _, _ = chip_smoke.KERNEL_SHAPES[base]
        assert fi.plan(B, K, R, C, tr, tc, sms, packed).lanes == lanes


def test_many_columns_take_fewer_tail_lanes_and_too_many_raise():
    assert fi.plan(4096, 64, 1, 1, 64, 512, 132).lanes == 4
    assert fi.plan(4096, 64, 1, 64, 64, 512, 132).lanes == 2   # 32,768
    assert fi.plan(4096, 64, 1, 128, 64, 512, 132).lanes == 1  # 65,536
    with pytest.raises(ValueError, match="clause columns"):
        fi.plan(4, 64, 1, 129, 64, 512, 132)


def test_plan_is_computed_once_per_shape():
    fi.plan.cache_clear()
    a = fi.plan(128, 1568, 1, 1, 2048, 512, 132)
    assert fi.plan(128, 1568, 1, 1, 2048, 512, 132) is a
    assert fi.plan.cache_info().hits == 1


def _lits(B, K, offset):
    """Contiguous int8 literals (B, K) ``offset`` bytes into a buffer."""
    buf = torch.zeros(B * K + 32, dtype=torch.int8)
    assert buf.data_ptr() % 16 == 0
    return buf[offset:offset + B * K].view(B, K)


def test_literal_copy_width_follows_pointer_k_and_tr():
    ci = torch.zeros((1, 1, 2048, 512))
    assert fi.copy_widths(_lits(4, 1568, 0), ci, 1, 2048)[0] == 16
    assert fi.copy_widths(_lits(4, 1568, 4), ci, 1, 2048)[0] == 1  # pointer
    assert fi.copy_widths(_lits(4, 1568, 1), ci, 1, 2048)[0] == 1
    assert fi.copy_widths(_lits(4, 1572, 0), ci, 1, 2048)[0] == 1  # K % 16
    assert fi.copy_widths(_lits(4, 1584, 0), ci, 1, 2048)[0] == 16
    # Several shards: shard r starts at byte r * tr of each row.
    assert fi.copy_widths(_lits(8, 512, 0), ci, 2, 256)[0] == 16
    assert fi.copy_widths(_lits(8, 528, 0), ci, 3, 200)[0] == 1    # 200
    assert fi.copy_widths(_lits(8, 528, 0), ci, 3, 176)[0] == 16
    assert fi.copy_widths(_lits(37, 300, 0), ci, 2, 150)[0] == 1   # 150


def test_clause_copy_width_follows_pointer_and_tc():
    lit = _lits(4, 64, 0)
    buf = torch.zeros(2 * 64 * 33 + 8)
    assert buf.data_ptr() % 16 == 0
    assert fi.copy_widths(lit, buf[:64 * 32].view(1, 1, 64, 32), 1, 64) \
        == (16, 16)
    assert fi.copy_widths(lit, buf[1:1 + 64 * 32].view(1, 1, 64, 32), 1,
                          64)[1] == 4                           # pointer
    assert fi.copy_widths(lit, buf[:64 * 33].view(1, 1, 64, 33), 1,
                          64)[1] == 4                           # tc % 4


@pytest.mark.parametrize("B,K,R,C,tr,tc", SHAPES[:len(chip_smoke.KERNEL_SHAPES)])
def test_chip_smoke_shapes_take_the_paths_they_are_meant_to(B, K, R, C, tr,
                                                            tc):
    """At chip_smoke's kernel shapes on aligned tensors: the paper shape
    copies 16-byte literal groups; K = 100 and 520 (not multiples of 16)
    and tr = 150 with two shards (shard 1 starts at an odd byte) take
    plain loads; tc = 11 takes 4-byte cell copies."""
    lit, cl = fi.copy_widths(_lits(B, K, 0), torch.zeros((R, C, tr, tc)),
                             R, tr)
    want_lit = {1568: 16, 100: 1, 300: 1, 520: 1, 64: 16}[K]
    assert lit == want_lit
    assert cl == (16 if tc % 4 == 0 else 4)

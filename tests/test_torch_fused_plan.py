"""The launch plan of ``fused_impact.cu``, computed on the host.

``repro_torch.kernels.fused_impact.plan`` picks pass 1's tile, splits each
row shard's live rows (``min(tr, K - r*tr)``; on the paired pass, the K/2
pairs of the first shard) into chunks of whole stages and sizes the
tail's blocks; the CUDA side only checks the plan, so its
properties are held here on the CPU with the SM count as a parameter, at
the shapes ``chip_smoke.py`` launches the kernels at and at edge cases:
every shard's live rows are covered once, the paper shape fills about
one wave, the packed plan fills about one wave of
``PACKED_BLOCKS_PER_SM`` blocks an SM with the f32 tile and stages, the
tail serves every lane once with the columns of each lane streamed once
and fits its shared memory, spreads a lane over several warps at small
batches and fills ``TAIL_BLOCKS_PER_SM`` full blocks an SM at the
benchmark's 16,384 lanes, and the copy widths (literals, f32 cells,
packed codes, the tail's loads) follow the operands' pointers and
strides.
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
# The benchmark's bulk batch in its MNIST and CIFAR-2 layouts.
BULK = [(B, K, R, C, tr, tc)
        for B, K, _, _, R, tr, C, tc, _, _ in chip_smoke.BULK_SHAPES]


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,K,R,C,tr,tc", SHAPES)
def test_chunks_cover_each_shards_live_rows_once(B, K, R, C, tr, tc, sms,
                                                 packed):
    p = fi.plan(B, K, R, C, tr, tc, sms, packed)
    assert p.chunk > 0 and p.chunk % p.stage == 0       # whole stages
    assert p.paired == fi.pairs(K, tr, packed)
    for r in range(R):
        # Paired, the chunks split the K/2 pairs, all in the first shard.
        live = ((K // 2 if r == 0 else 0) if p.paired
                else max(0, min(tr, K - r * tr)))
        rows = [k for s in range(p.splits)
                for k in range(s * p.chunk, min(live, (s + 1) * p.chunk))]
        assert rows == list(range(live))                 # in order, once
    fullest = K // 2 if p.paired else max(0, min(tr, K))
    assert p.splits == max(1, _cdiv(fullest, p.chunk))   # none empty
    tiles = _cdiv(B, p.tile_b) * C * _cdiv(tc, p.tile_n) * R
    assert p.blocks == tiles * p.splits
    if p.splits > 1:          # fills the ring: a paired stage copies two
        assert (2 if p.paired else 1) * p.chunk >= (
            fi.MIN_SPLIT_STAGES * p.stage)


def _tail_columns(p, N, width):
    """How often the tail loads each column of a lane and writes each
    fired word, by the kernel's map: thread tg of the lane's group of
    G = 32 * tail_warps threads loads column groups tg + k * G of
    ``width`` columns, and lanes 0..width-1 of each warp write the words
    of its 32 * width columns."""
    G = 32 * p.tail_warps
    groups, words = N // width, _cdiv(N, 32)
    rounds = _cdiv(groups, G)
    cols, fired = [0] * N, [0] * words
    for k in range(rounds):
        for tg in range(G):
            g = k * G + tg
            if g < groups:
                for e in range(width):
                    cols[g * width + e] += 1
        for wig in range(p.tail_warps):
            g0 = k * G + 32 * wig
            for w in range(width):
                at = g0 * width // 32 + w
                if g0 < groups and at < words:
                    fired[at] += 1
    return cols, fired


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,K,R,C,tr,tc", SHAPES + BULK)
def test_tail_lanes_fit_the_fired_bits(B, K, R, C, tr, tc, sms):
    """Every lane is served once, by a group of whole warps, and a block's
    fired words and f64 clause-meter partials (one a warp) fit the tail's
    shared memory."""
    for packed in (False, True):
        p = fi.plan(B, K, R, C, tr, tc, sms, packed)
        assert p.tail_warps in (1, 2, 4, 8) and p.lanes in (1, 2, 4, 8)
        assert p.tail_threads == 32 * p.tail_warps * p.lanes
        assert p.tail_threads <= fi.TAIL_THREADS
        assert p.lanes * _cdiv(C * tc, 32) <= fi.TAIL_FIRED_WORDS
        assert p.tail_blocks == _cdiv(B, p.lanes)
        served = [blk * p.lanes + l for blk in range(p.tail_blocks)
                  for l in range(p.lanes)]
        assert [b for b in served if b < B] == list(range(B))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,K,R,C,tr,tc", SHAPES + BULK)
def test_tail_streams_each_column_once(B, K, R, C, tr, tc, sms):
    """Under the plan's warps a lane, the tail loads every column of a
    lane once and writes every fired word once, by 16-byte loads (where
    C*tc % 4 == 0) and by plain ones."""
    N = C * tc
    p = fi.plan(B, K, R, C, tr, tc, sms)
    for width in (4, 1) if N % 4 == 0 else (1,):
        cols, fired = _tail_columns(p, N, width)
        assert cols == [1] * N and fired == [1] * _cdiv(N, 32)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,K,R,C,tr,tc", BULK)
def test_bulk_batch_fills_the_planned_blocks_an_sm(B, K, R, C, tr, tc, sms):
    """At the benchmark's 16,384 lanes the tail takes a warp a lane in
    full blocks, at least ``TAIL_BLOCKS_PER_SM`` of them an SM, which
    hold 32 resident warps an SM."""
    for packed in (False, True):
        p = fi.plan(B, K, R, C, tr, tc, sms, packed)
        assert (p.tail_warps, p.tail_threads) == (1, fi.TAIL_THREADS)
        assert p.tail_blocks >= fi.TAIL_BLOCKS_PER_SM * sms
        assert fi.TAIL_BLOCKS_PER_SM * fi.TAIL_THREADS // 32 >= 32


@pytest.mark.parametrize("sms", SMS)
def test_paper_shape_fills_about_one_wave(sms):
    """16 tiles of 64 x 64 (lanes x columns) at B = 128, the paired pass
    over 784 pairs split into 13 chunks of 64 pairs: 208 blocks, about
    one wave at two blocks an SM."""
    p = fi.plan(128, 1568, 1, 1, 2048, 512, sms)
    wave = fi.BLOCKS_PER_SM * sms
    assert (p.tile_b, p.tile_n, p.stage) == fi.F32_TILE == (64, 64, 16)
    assert p.paired
    assert (p.splits, p.chunk, p.blocks) == (13, 64, 208)
    assert 0.75 * wave <= p.blocks <= wave
    # The tail spreads each of the 128 lanes over 4 warps, one 16-byte
    # column group a thread.
    assert (p.tail_warps, p.lanes, p.tail_blocks) == (4, 1, 128)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,K,R,C,tr,tc", SHAPES)
def test_packed_plan_fills_about_one_wave_in_whole_stages(B, K, R, C, tr,
                                                          tc, sms):
    """The packed pass 1 runs the f32 tile and stages: chunks of whole
    16-row stages, at least ``MIN_SPLIT_STAGES`` deep where split, and no
    more blocks than a wave of ``PACKED_BLOCKS_PER_SM`` an SM, nor fewer
    than 80% of what fits beside the last tile where the rows allow."""
    p = fi.plan(B, K, R, C, tr, tc, sms, packed=True)
    assert (p.tile_b, p.tile_n, p.stage) == fi.F32_TILE
    assert p.chunk % 16 == 0
    if p.splits > 1:
        assert p.chunk >= fi.MIN_SPLIT_STAGES * p.stage
    wave = fi.PACKED_BLOCKS_PER_SM * sms
    tiles = _cdiv(B, 64) * C * _cdiv(tc, 64) * R
    stages = _cdiv(max(0, min(tr, K)), 16)
    assert p.blocks <= max(tiles, wave)
    if tiles and wave // tiles <= stages // fi.MIN_SPLIT_STAGES:
        assert p.blocks >= 0.8 * (wave - tiles)
    # The tail keeps the f32 plan's warps and lanes.
    f = fi.plan(B, K, R, C, tr, tc, sms)
    assert (p.tail_warps, p.lanes, p.tail_blocks) == (
        f.tail_warps, f.lanes, f.tail_blocks)


@pytest.mark.parametrize("sms", SMS)
def test_packed_paper_shape_runs_224_blocks(sms):
    """16 tiles of 64 x 64 at B = 128, 98 stages in 14 chunks of 112
    rows: 224 blocks, 0.85 (132 SMs) or 0.98 (114) of a wave of two
    blocks an SM, the measured best for the packed pass."""
    assert fi.PACKED_BLOCKS_PER_SM == 2
    p = fi.plan(128, 1568, 1, 1, 2048, 512, sms, packed=True)
    assert (p.tile_b, p.tile_n, p.stage) == (64, 64, 16)
    assert (p.splits, p.chunk, p.blocks) == (14, 112, 224)
    assert 0.75 * fi.PACKED_BLOCKS_PER_SM * sms <= p.blocks
    assert (p.tail_warps, p.lanes, p.tail_blocks) == (4, 1, 128)


def test_edge_cases_plan_without_error():
    assert fi.plan(0, 1568, 1, 1, 2048, 512, 132).blocks == 0
    assert fi.plan(0, 1568, 1, 1, 2048, 512, 132).tail_blocks == 0
    short = fi.plan(5, 210, 3, 1, 100, 40, 132)      # shard 2: 10 rows
    assert short.splits * short.chunk >= 100
    p = fi.plan(5, 100, 1, 1, 2048, 512, 132)        # K < tr: 50 pairs
    assert p.paired and p.splits * p.chunk >= 50 > (p.splits - 1) * p.chunk


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,want", [
    (chip_smoke.N_CALIBRATION, {132: ((4, 2), (1, 4)), 114: ((2, 4), (1, 8))}),
    (300, {132: ((4, 2), (1, 2)), 114: ((4, 2), (1, 2))}),
    (chip_smoke.CAPACITY, {132: ((4, 1), (1, 1)), 114: ((4, 1), (1, 1))})])
def test_chip_smoke_batches_plan_every_tail_lane_count(B, want, sms, packed):
    """chip_smoke's tail check holds the kernels at the calibration batch
    and at 300 lanes, whose (warps a lane, lanes a block) at the paper
    and the multi-shard layouts give a lane several warps and a block
    several lanes; the serving capacity spreads a paper lane over 4
    warps, a block a lane."""
    for base, w in zip((0, 2), want[sms]):
        _, K, _, _, R, tr, C, tc, _, _ = chip_smoke.KERNEL_SHAPES[base]
        p = fi.plan(B, K, R, C, tr, tc, sms, packed)
        assert (p.tail_warps, p.lanes) == w


def test_many_columns_take_fewer_tail_lanes_and_too_many_raise():
    assert fi.plan(4096, 64, 1, 1, 64, 512, 132).lanes == 8
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


def _codes(shape, offset):
    """Contiguous uint8 codes of ``shape`` ``offset`` bytes into a
    buffer."""
    n = 1
    for d in shape:
        n *= d
    buf = torch.zeros(n + 32, dtype=torch.uint8)
    assert buf.data_ptr() % 16 == 0
    return buf[offset:offset + n].view(shape)


@pytest.mark.parametrize("B,K,R,C,tr,tc", SHAPES[:len(chip_smoke.KERNEL_SHAPES)])
def test_chip_smoke_shapes_take_the_code_paths_they_are_meant_to(B, K, R, C,
                                                                 tr, tc):
    """At chip_smoke's kernel shapes, codes on an aligned base or four
    bytes off it take 4-byte copies where tc % 4 == 0 (512, 64, 256) and
    plain loads at tc = 30 and 11; one or two bytes off, plain loads."""
    shape = (R, C, -(-tr // 4), tc)
    want = 4 if tc % 4 == 0 else 1
    assert {16: 4, 64: 4, 256: 4, 512: 4, 30: 1, 11: 1}.get(tc) == want
    assert fi.code_width(_codes(shape, 0)) == want
    assert fi.code_width(_codes(shape, 4)) == want
    assert fi.code_width(_codes(shape, 1)) == 1
    assert fi.code_width(_codes(shape, 2)) == 1


@pytest.mark.parametrize("offset,N,width", [
    (0, 512, 4), (0, 1024, 4), (4, 512, 4), (1, 512, 1), (2, 512, 1),
    (0, 90, 1), (0, 33, 1), (0, 0, 4)])
def test_tail_load_width_follows_pointer_and_columns(offset, N, width):
    """The tail reads the partials 16 bytes at a time where their base is
    16-byte aligned and N = C*tc % 4 == 0, else a float at a time."""
    buf = torch.zeros(N * 3 + 16)
    assert buf.data_ptr() % 16 == 0
    assert fi.tail_width(buf[offset:offset + N * 3], N) == width


@pytest.mark.parametrize("offset,tc,width", [
    (0, 512, 4), (8, 512, 4), (2, 512, 1), (3, 512, 1), (0, 20, 4),
    (0, 18, 1), (12, 32, 4), (16, 6, 1)])
def test_code_copy_width_follows_pointer_and_tc(offset, tc, width):
    """4-byte code copies need the base and tc to be multiples of 4; no
    code copy is wider (16-byte ones measured slower)."""
    assert fi.code_width(_codes((1, 1, 8, tc), offset)) == width


def test_describe_names_the_packed_path(monkeypatch):
    """``describe`` on the packed codes (``tr`` given) names the code
    path and the packed plan; on clause_i, the cell path and the f32
    plan, here the paired pass (132 SMs)."""
    monkeypatch.setattr(fi, "sm_count", lambda index: 132)
    lit = _lits(128, 1568, 0)
    assert fi.describe(lit, _codes((1, 1, 512, 512), 1), 2048) == (
        "64x64 tiles, literals by 16-byte copies, codes by plain loads, 14 "
        "chunk(s) of 112 rows a shard, 224 blocks; tail 128 blocks of 1 "
        "lane(s), 4 warp(s) a lane")
    assert "codes by 4-byte copies" in fi.describe(
        lit, _codes((1, 1, 512, 512), 0), 2048)
    assert fi.describe(lit, torch.zeros((1, 1, 2048, 512))) == (
        "64x64 tiles, paired pass over 784 literal pairs, literals by "
        "16-byte copies, cells by 16-byte copies, 13 chunk(s) of 64 pairs, "
        "208 blocks; tail 128 blocks of 1 lane(s), 4 warp(s) a lane")

"""The launch plans and load widths of ``ta_feedback.cu`` and of the
digital clause stage (``digital_cotm.cu``: ``clause_eval``, ``fused_cotm``),
computed on the host.

``repro_torch.kernels.ta_feedback.plan`` gives the grid of 128 x 32 (K,
n) tiles and the passes over 2B, ``clause_eval.plan`` the grid of 32 x 32
(b, j) tiles and the K stages; ``widths`` pick the load widths; the CUDA
side only checks what it is given.  So their properties are held here on
the CPU, at the shapes ``chip_smoke.py`` launches the kernels at and at
edge cases: the grid covers every (k, j) and every (b, j) once and fills
an H100 at the trainer's shapes, a 2B past one pass of words takes more
passes, the wide loads are taken only where the shapes and the base
pointers allow them (views one element or one byte off an aligned base
take the plain loads), shared memory fits, and the Python constants are
the CUDA sources' own.
"""
import importlib
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

tf = importlib.import_module("repro_torch.kernels.ta_feedback")
ce = importlib.import_module("repro_torch.kernels.clause_eval")

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SMS = (132, 114)          # H100 SXM, H100 PCIe
# Shared memory a block may use on Hopper, and the static part's limit.
SMEM_PER_SM, STATIC_LIMIT = 232_448, 48 * 1024
# (2B, K, n): chip_smoke's shapes, then no row, one cell, one row past a
# pass, many passes, n and K off the tiles.
FEEDBACK = list(chip_smoke.FEEDBACK_SHAPES) + [
    (0, 1568, 500), (1, 1, 1), (129, 1568, 500), (1000, 64, 64),
    (32, 4097, 31), (128, 33, 129)]
# (B, K, N): chip_smoke's digital shapes, then one lane, K past two
# stages, lanes and columns one past a tile.
DIGITAL = [(B, K, N) for B, K, N, _ in chip_smoke.DIGITAL_SHAPES] + [
    (1, 1, 1), (256, 4100, 500), (33, 1568, 33), (4096, 1568, 500)]


def _constants(path: pathlib.Path) -> dict[str, int]:
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", path.read_text())}


def test_python_constants_are_the_sources():
    c = _constants(CSRC / "ta_feedback.cu")
    assert (c["THREADS"], c["KT"], c["NT"], c["PASS_WORDS"], c["CHUNK"],
            c["PAD"]) == (tf.THREADS, tf.KT, tf.NT, tf.PASS_WORDS,
                          tf.CHUNK, tf.PAD)
    d = _constants(CSRC / "digital_cotm.cu")
    assert (d["THREADS"], d["TB"], d["TJ"], d["KW"], d["KPAD"]) == (
        ce.THREADS, ce.LANES, ce.COLS, ce.STAGE_WORDS, ce.PAD_WORDS)
    assert _constants(CSRC / "bit_pack.cuh")["ROW_PAD"] == 16


@pytest.mark.parametrize("rows,K,n", FEEDBACK)
def test_feedback_grid_covers_every_cell_once(rows, K, n):
    p = tf.plan(rows, K, n)
    assert (p.kt, p.nt) == (tf.KT, tf.NT)
    gx, gy = p.grid
    assert p.blocks == gx * gy
    hits = np.zeros((K, n), np.int64)
    for by in range(gy):
        for bx in range(gx):
            hits[by * p.kt:(by + 1) * p.kt, bx * p.nt:(bx + 1) * p.nt] += 1
    assert (hits == 1).all()
    # No block lies wholly past the edge.
    assert (gx - 1) * p.nt < max(n, 1) and (gy - 1) * p.kt < max(K, 1)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("rows,K,n", FEEDBACK)
def test_feedback_plan_fills_the_card_where_a_tile_can(rows, K, n, sms):
    p = tf.plan(rows, K, n)
    assert p.blocks == -(-n // tf.NT) * -(-K // tf.KT)
    # A block an SM wherever (K, n) holds a tile's worth of cells an SM;
    # the trainer's updates (K = 1568, n = 500) give 208 blocks.
    if K * n >= sms * tf.KT * tf.NT or (K, n) == (1568, 500):
        assert p.blocks >= sms


@pytest.mark.parametrize("rows,passes", [(0, 0), (1, 1), (32, 1),
                                         (128, 1), (129, 2), (256, 2),
                                         (300, 3), (1000, 8)])
def test_feedback_passes_of_words(rows, passes):
    p = tf.plan(rows, 1568, 500)
    assert p.pass_words == tf.PASS_WORDS == 4
    assert p.passes == passes
    # The trainer's updates (2B = 32 and 128) take one pass.
    assert tf.plan(2 * chip_smoke.ONLINE_BATCH, 1568, 500).passes == 1
    assert tf.plan(chip_smoke.REFERENCE_UPDATE_ROWS, 1568, 500).passes == 1


def test_feedback_paper_shape_plan():
    # 208 blocks of 128 x 32 on 132 SMs: the mask re-reads (3 * 2B * 32
    # bytes a block) are 6% of the block's stream at 2B = 32.
    p = tf.plan(32, 1568, 500)
    assert (p.kt, p.nt, p.grid, p.blocks) == (128, 32, (16, 13), 208)
    assert 3 * 32 * p.nt / (13 * p.kt * p.nt) < 0.1


def _feedback_ops(rows, K, n, offset=0, lit_offset=0, mask_offset=0):
    """Contiguous operands, hi / lo one int32 ``offset`` and the literals
    and sel ``lit_offset`` / ``mask_offset`` bytes past an aligned base."""
    def at(shape, dtype, off):
        buf = torch.zeros(int(np.prod(shape)) + 16, dtype=dtype)
        return buf[off:off + int(np.prod(shape))].view(shape)
    lit2 = at((rows, K), torch.int8, lit_offset)
    sel = at((rows, n), torch.bool, mask_offset)
    masks = (sel, torch.zeros(rows, n, dtype=torch.bool),
             torch.zeros(rows, n, dtype=torch.bool),
             torch.zeros(K, n, dtype=torch.bool))
    words = (at((K, n), torch.int32, offset), at((K, n), torch.int32, 0),
             torch.zeros(K, n, dtype=torch.int32))
    return lit2, masks, words


@pytest.mark.parametrize("case,want", [
    (dict(), (4, 16)),
    (dict(offset=1), (1, 16)),           # hi one element off: 4-byte aligned
    (dict(offset=4), (4, 16)),           # four elements: 16-byte aligned
    (dict(mask_offset=1), (1, 16)),      # sel one byte off
    (dict(lit_offset=1), (4, 1)),        # literals one byte off
    (dict(lit_offset=4), (4, 1)),        # 4-byte aligned is not enough
    (dict(lit_offset=16), (4, 16)),
])
def test_feedback_widths_follow_the_pointers(case, want):
    lit2, masks, words = _feedback_ops(32, 1568, 500, **case)
    assert tf.widths(lit2, masks, words) == want


@pytest.mark.parametrize("K,n,want", [(1568, 500, (4, 16)),
                                      (1568, 77, (1, 16)), (132, 500, (4, 1)),
                                      (33, 5, (1, 1))])
def test_feedback_widths_follow_the_shape(K, n, want):
    lit2, masks, words = _feedback_ops(32, K, n)
    assert tf.widths(lit2, masks, words) == want


def test_feedback_shared_memory_fits_two_blocks_an_sm():
    # All of it static, under the limit a launch needs no opt-in for.
    assert tf.PACKED_BYTES + tf.RAW_BYTES <= STATIC_LIMIT
    assert 2 * (tf.PACKED_BYTES + tf.RAW_BYTES) <= SMEM_PER_SM
    # The raw bytes hold a pass's tiles and, later, two counts a cell.
    assert tf.RAW_BYTES >= 32 * tf.PASS_WORDS * (3 * tf.NT + tf.KT)
    assert tf.RAW_BYTES >= 2 * 4 * tf.KT * tf.NT


@pytest.mark.parametrize("B,K,N", DIGITAL)
def test_clause_grid_covers_every_output_once(B, K, N):
    p = ce.plan(B, K, N)
    assert (p.lanes, p.cols) == (ce.LANES, ce.COLS) == (32, 32)
    gx, gy = p.grid
    assert p.blocks == gx * gy
    hits = np.zeros((B, N), np.int64)
    for by in range(gy):
        for bx in range(gx):
            hits[by * p.lanes:(by + 1) * p.lanes,
                 bx * p.cols:(bx + 1) * p.cols] += 1
    assert (hits == 1).all()
    assert p.stages == -(-(-(-K // 32)) // ce.STAGE_WORDS)


@pytest.mark.parametrize("B,K,N,grid", [
    (256, 1568, 500, (16, 8)),    # the quickstart's: 128 blocks
    (100, 3000, 500, (16, 4)),
    (5, 70, 33, (2, 1)), (4096, 1568, 500, (16, 128))])
def test_clause_lane_tile(B, K, N, grid):
    p = ce.plan(B, K, N)
    assert (p.lanes, p.grid, p.blocks) == (32, grid, grid[0] * grid[1])


@pytest.mark.parametrize("K,stages", [(1, 1), (2048, 1), (2049, 2),
                                      (3000, 2), (4100, 3)])
def test_clause_stages(K, stages):
    assert ce.plan(8, K, 40).stages == stages


def _clause_ops(B, K, N, lit_offset=0, inc_offset=0):
    lbuf = torch.zeros(B * K + 16, dtype=torch.int8)
    ibuf = torch.zeros(K * N + 16, dtype=torch.bool)
    return (lbuf[lit_offset:lit_offset + B * K].view(B, K),
            ibuf[inc_offset:inc_offset + K * N].view(K, N))


@pytest.mark.parametrize("B,K,N,case,want", [
    (256, 1568, 500, dict(), (16, 4)),
    (256, 1568, 500, dict(lit_offset=1), (1, 4)),
    (256, 1568, 500, dict(lit_offset=16), (16, 4)),
    (256, 1568, 500, dict(inc_offset=1), (16, 1)),
    (256, 1568, 500, dict(inc_offset=4), (16, 4)),
    (5, 70, 33, dict(), (1, 1)),          # K and N off 16 and 4
    (9, 3000, 129, dict(), (1, 1)),
    (9, 2048, 64, dict(), (16, 4)),
])
def test_clause_widths_follow_pointers_and_shape(B, K, N, case, want):
    assert ce.widths(*_clause_ops(B, K, N, **case)) == want


@pytest.mark.parametrize("fused", [False, True])
def test_clause_shared_memory_fits(fused):
    # One 512-thread block an SM, at the largest stage (64 words).
    total = ce.smem_bytes(64 * 32, fused)
    assert total <= SMEM_PER_SM
    assert total - ce.smem_bytes(0, fused) == 64 * 32 * 48
    assert ce.smem_bytes(0, fused) <= STATIC_LIMIT


def test_unaligned_views_take_the_plain_route_on_the_cpu():
    """On the CPU the wrappers take the plain versions, whatever the
    alignment, bit for bit."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(0)
    lbuf = torch.from_numpy(rng.random(37 * 70 + 1) < 0.8).to(torch.int8)
    ibuf = torch.from_numpy(rng.random(70 * 33 + 1) < 0.05)
    lit, inc = lbuf[1:].view(37, 70), ibuf[1:].view(70, 33)
    ne = inc.any(0)
    assert torch.equal(ce.clause_eval(lit, inc, ne),
                       ref.clause_eval_ref(lit, inc, ne))
    ops = chip_smoke.feedback_operands((42, 130, 129), "cpu", seed=3)
    assert torch.equal(tf.ta_feedback(*ops), ref.ta_feedback_ref(*ops))

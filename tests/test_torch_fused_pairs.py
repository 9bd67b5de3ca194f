"""The paired pass 1 of ``fused_impact.cu``, on the host.

Where every literal vector is ``[bits, ~bits]``, exactly one row of each
pair (f, K/2 + f) is driven, and ``impact_tiles`` runs paired: one FFMA a
pair over D = G[f] - G[K/2 + f], a second loop only over the pairs that
do not hold, and each column's sum of the second rows added once.  Held
here: when the plan pairs (f32 cells, K even, K <= tr) and how it chunks
the pairs, the literal copy width of the second half, ``describe``'s
words, the priced FLOPs (``kernels.work``), the program counters of the
two passes and the identity itself, in plain PyTorch f64, against the
plain version on paired, unpaired and arbitrary int8 literals.
"""
import importlib

import pytest
import torch

from repro_torch import tracing
from repro_torch.kernels import _build, ref, work

fi = importlib.import_module("repro_torch.kernels.fused_impact")

TH = 4.1e-6


@pytest.mark.parametrize("K,tr,packed,want", [
    (1568, 2048, False, True), (2048, 2048, False, True),
    (2, 16, False, True), (200, 256, False, True),
    (1567, 2048, False, False),            # odd K
    (4096, 2048, False, False),            # pairs straddle two shards
    (1568, 2048, True, False),             # packed codes: the full pass
    (0, 16, False, False)])
def test_pairs_on_even_k_within_one_shard_of_f32_cells(K, tr, packed, want):
    assert fi.pairs(K, tr, packed) is want


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("B,K,R,C,tr,tc", [
    (16384, 1568, 1, 1, 2048, 512), (16384, 2048, 1, 2, 2048, 512),
    (128, 1568, 1, 1, 2048, 512), (65, 300, 1, 3, 300, 30),
    (1, 200, 1, 1, 256, 128)])
def test_paired_plan_chunks_the_pairs(B, K, R, C, tr, tc, sms):
    """The paired plan splits the K/2 pairs (not K rows) into chunks of
    whole 16-pair stages, none empty, with the blocks of every tile of
    every shard; at the benchmark's 16,384 lanes one chunk holds every
    pair, as the full plan holds every row."""
    p = fi.plan(B, K, R, C, tr, tc, sms)
    full = fi.plan(B, K, R, C, tr, tc, sms, packed=True)
    assert p.paired and not full.paired
    F = K // 2
    assert p.chunk % 16 == 0 and p.splits == -(-F // p.chunk)
    assert (p.splits - 1) * p.chunk < F <= p.splits * p.chunk
    tiles = -(-B // 64) * C * -(-tc // 64) * R
    assert p.blocks == tiles * p.splits
    assert p.blocks <= max(tiles, fi.BLOCKS_PER_SM * sms)
    if B == 16384:
        assert (p.splits, p.chunk) == (1, F) and full.splits == 1
    # The tail does not see how pass 1 ran.
    assert (p.tail_warps, p.lanes, p.tail_blocks) == (
        full.tail_warps, full.lanes, full.tail_blocks)


@pytest.mark.parametrize("B,K,R,C,tr,tc", [
    (128, 1567, 1, 1, 2048, 512),          # odd K
    (8, 4096, 2, 1, 2048, 512),            # the R = 2 head: K > tr
    (37, 300, 2, 3, 150, 30)])             # pairs straddle the shards
def test_full_pass_where_pairs_do_not_fit(B, K, R, C, tr, tc):
    """Odd K and pairs across shards run the full pass: the chunks split
    the fullest shard's live rows, as before pairing existed."""
    p = fi.plan(B, K, R, C, tr, tc, 132)
    assert not p.paired
    live = min(tr, K)
    assert (p.splits - 1) * p.chunk < live <= p.splits * p.chunk
    assert p == fi.plan(B, K, R, C, tr, tc, 132, packed=True)


def _lits(B, K, offset=0):
    buf = torch.zeros(B * K + 32, dtype=torch.int8)
    assert buf.data_ptr() % 16 == 0
    return buf[offset:offset + B * K].view(B, K)


@pytest.mark.parametrize("K,offset,width", [
    (1568, 0, 16), (2048, 0, 16), (32, 0, 16), (1568, 1, 1),
    (48, 0, 1),                            # K % 16 == 0 but K/2 % 16 != 0
    (200, 0, 1), (300, 0, 1)])
def test_paired_literal_copies_need_half_k_on_16_bytes(K, offset, width):
    """The second literal of each pair starts K/2 bytes into the row:
    16-byte copies need K/2 (and the base) on a multiple of 16."""
    ci = torch.zeros((1, 1, 2048, 64))
    assert fi.copy_widths(_lits(4, K, offset), ci, 1, 2048,
                          paired=True)[0] == width


def test_describe_names_the_paired_and_the_full_pass(monkeypatch):
    monkeypatch.setattr(fi, "sm_count", lambda index: 132)
    cells = torch.zeros((1, 2, 2048, 512))
    got = fi.describe(_lits(16384, 2048), cells)
    assert got.startswith("64x64 tiles, paired pass over 1024 literal "
                          "pairs, literals by 16-byte copies, cells by "
                          "16-byte copies, 1 chunk(s) of 1024 pairs, 4096 "
                          "blocks;")
    odd = fi.describe(_lits(4, 300), torch.zeros((1, 3, 300, 30)))
    assert odd.startswith("64x64 tiles, paired pass over 150 literal pairs, "
                          "literals by plain loads, cells by 4-byte copies")
    head = fi.describe(_lits(8, 4096), torch.zeros((2, 1, 2048, 512)))
    assert "paired" not in head
    assert "chunk(s) of 128 rows a shard" in head


@pytest.mark.parametrize("metered", [False, True])
def test_work_prices_the_rows_the_pass_multiplies(metered):
    """``kernels.work.fused_impact``: the paired pass reads every live
    row's cells but multiplies K/2 of them a lane; packed codes, odd K
    and pairs across shards multiply every live row."""
    B, N, Nc, M = 128, 512, 2048, 10
    cls = 2.0 * B * min(N, Nc) * M
    paired, bytes_paired = work.fused_impact(B, 1568, 1, 2048, N, Nc, M,
                                             metered=metered)
    assert paired == 2.0 * B * 784 * N + cls
    packed, _ = work.fused_impact(B, 1568, 1, 2048, N, Nc, M,
                                  metered=metered, packed=True)
    assert packed == 2.0 * B * 1568 * N + cls
    odd, _ = work.fused_impact(B, 1567, 1, 2048, N, Nc, M, metered=metered)
    assert odd == 2.0 * B * 1567 * N + cls
    head, _ = work.fused_impact(B, 4096, 2, 2048, N, Nc, M, metered=metered)
    assert head == 2.0 * B * 4096 * N + cls
    # Bytes are what the inputs need: both rows of every pair.
    full = 1568 * N * 4
    assert bytes_paired == (B * 1568 + full + N + min(N, Nc) * M * 4
                            + (B * M + (2 * B if metered else 0)) * 4)


def test_tally_counts_at_launch_and_at_each_replay():
    """A pass-1 counter counts with its launch: at once outside a
    capture, into the capture's record inside one, and again with every
    replay of that record."""
    tracing.reset()
    tracing.enable()
    try:
        _build.tally(fi.PAIRED_LAUNCHES)
        with _build.record_launches() as rec:
            _build.tally(fi.PAIRED_LAUNCHES)
            _build.tally(fi.FULL_LAUNCHES)
        assert tracing.totals()[fi.PAIRED_LAUNCHES]["count"] == 1
        assert _build.record_symbols(rec) == {}
        for _ in range(3):
            _build.add_launches(rec)
        counts = {k: v["count"] for k, v in tracing.totals().items()}
    finally:
        tracing.disable()
        tracing.reset()
    assert counts == {fi.PAIRED_LAUNCHES: 4, fi.FULL_LAUNCHES: 3}


def _system(gen, B, F, C, tc, tr, kind):
    """Cells in the physical regime (HCS ~5 uA at a few includes a
    column, LCS ~3 nA), a class tile, and literals (B, 2F) of ``kind``."""
    K = 2 * F
    inc = torch.rand((tr, C * tc), generator=gen) < 3.0 / K
    cur = torch.where(inc, 5e-6, 3e-9) * (
        1 + 0.05 * torch.randn((tr, C * tc), generator=gen))
    clause_i = cur.reshape(tr, C, tc).permute(1, 0, 2)[None].contiguous()
    nonempty = inc[:K].any(dim=0)
    class_i = torch.rand((1, C * tc, 3), generator=gen) * 2.5e-6
    if kind == "paired":
        bits = torch.rand((B, F), generator=gen) < 0.5
        lit = torch.cat([bits, ~bits], dim=1).to(torch.int8)
    elif kind == "unpaired":
        lit = torch.randint(0, 2, (B, K), generator=gen, dtype=torch.int8)
    else:
        lit = torch.randint(-128, 128, (B, K), generator=gen,
                            dtype=torch.int8)
    return lit, clause_i, nonempty, class_i.float()


@pytest.mark.parametrize("kind", ["paired", "unpaired", "int8"])
def test_pairing_identity_holds_for_any_int8_literals(kind):
    """In f64: sum_f t G[f] + (1 - lit[F + f]) G[F + f] equals
    c + t @ D + e @ G[F + f] (c the column sums of the second rows,
    D = G[f] - G[F + f], e = 1 - lit[f] - lit[F + f]); e is 0 on paired
    literals.  The CSA bits, scores and meters it gives equal the plain
    version's at its own tolerances (bits exact)."""
    gen = torch.Generator().manual_seed(39)
    B, F, C, tc, tr = 24, 40, 2, 24, 96
    lit, clause_i, nonempty, class_i = _system(gen, B, F, C, tc, tr, kind)
    K = 2 * F
    G = clause_i[0].double().permute(1, 0, 2).reshape(tr, C * tc)
    lo, hi = lit[:, :F].double(), lit[:, F:].double()
    t, e = 1 - lo, 1 - lo - hi
    c = G[F:K].sum(dim=0)
    paired = c + t @ (G[:F] - G[F:K]) + e @ G[F:K]
    direct = (1 - lit.double()) @ G[:K]
    scale = ((1 - lit.double()).abs() @ G[:K]).max()
    torch.testing.assert_close(paired, direct, rtol=0, atol=1e-12 * scale)
    assert (e == 0).all() == (kind == "paired")

    fired = (paired < TH) & nonempty
    scores = fired.double() @ class_i[0].double()
    want, meter_cl, meter_cs = ref.fused_impact_metered_ref(
        lit, clause_i, nonempty, class_i, thresh=TH)
    ref_bits, _ = ref.impact_clause_bits_ref(lit, clause_i, nonempty,
                                             thresh=TH)
    assert torch.equal(fired, ref_bits) and fired.any()
    torch.testing.assert_close(scores.float(), want, rtol=1e-6, atol=0)
    torch.testing.assert_close(paired.sum(dim=1).float(), meter_cl,
                               rtol=1e-3, atol=0)
    torch.testing.assert_close(scores.sum(dim=1).float(), meter_cs,
                               rtol=1e-5, atol=0)

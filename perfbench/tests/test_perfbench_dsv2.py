"""The ``dsv2`` family at a size the CPU holds: DeepSeek-V2-Lite's
configuration cut in the test to three layers of width 64 (one dense, two
of 8 experts, top 2), a vocabulary of 512, a head of 128 literals on two
row shards, and two batches of two short documents.  ``deploy``,
``pool``, ``Cell.batch`` and ``check`` pass on the program and fail with
``control_output`` (the reference at 3 mantissa bits) in its place; the
new per-layer readers read the program's spans and counters."""
import copy
import time

import pytest
import torch

from perfbench import calibrate, harness
from perfbench.families import dsv2

#: Bounds at this size (the cell's own limits are set on the card at its
#: size): the program read hidden 7e-3, features 7e-3, flips 1/64; the
#: control 8e-2, 9e-2 and 2/64.
TINY_LIMITS = dict(hidden_err=0.03, feature_err=0.03, clause_bill=2e-6,
                   class_stage=4e-6, report_count=0)
SEED = 2 ** 31 + 5


def tiny() -> dict:
    s = copy.deepcopy(harness.spec("dsv2lite.docs-bulk"))
    c = s["config"]
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, num_hidden_layers=3, n_routed_experts=8,
             num_experts_per_tok=2, moe_intermediate_size=32,
             n_shared_experts=1, intermediate_size=128, vocab_size=512)
    h = c["assumed"]["head"]
    h.update(n_literals=128, n_clauses=20, max_tile_rows=64,
             max_tile_cols=16, max_class_rows=16)
    h["assumed"].update(include_density=0.05)
    s["traffic"].update(batch=2, pool_batches=2, length_median=24,
                        length_min=8, length_max=48, pad_to=8,
                        positions_checked=4)
    s["limits"] = dict(TINY_LIMITS)
    return s


def broken(readings, limits):
    return [n for n, lim in limits.items() if not readings[n] <= lim]


def test_program_passes_and_control_fails():
    s = tiny()
    prog = calibrate.program_readings(s, SEED, "cpu")
    assert not broken(prog, s["limits"]) and prog["failed"] == 0, prog
    ctrl = calibrate.control_readings(s, SEED, "cpu")
    assert {"hidden_err", "feature_err"} <= set(broken(ctrl, s["limits"]))


def test_a_whole_run_is_correct():
    r = harness.run(tiny(), SEED + 2, 0.2, False, "cpu", time.perf_counter())
    assert r["correct"] and r["failed"] == 0
    assert r["attempted"] % 2 == 0 and r["attempted"] >= 2


def test_pool_is_the_traffic():
    """Lengths the lognormal's quantiles whatever the seed, sorted, each
    batch padded to its longest rounded up; ids in the vocabulary;
    checked positions valid, the last one each document's last."""
    s = tiny()
    gen = torch.Generator().manual_seed(SEED)
    dep = dsv2.deploy(s["config"], gen)
    pools = [dsv2.pool(dep, s["traffic"], torch.Generator().manual_seed(k))
             for k in (1, 2)]
    lens = [b.lens for b in pools[0]]
    assert lens == [b.lens for b in pools[1]]
    flat = [n for ls in lens for n in ls]
    assert flat == sorted(flat) and min(flat) >= 8 and max(flat) <= 48
    for b in pools[0]:
        S = b.tokens.shape[1]
        assert S % 8 == 0 and S - 8 < max(b.lens) <= S
        assert int(b.tokens.max()) < 512
        for j, n in enumerate(b.lens):
            assert int(b.positions[j].max()) == n - 1
            assert bool((b.tokens[j, n:] == 0).all())
    assert not torch.equal(pools[0][0].tokens, pools[1][0].tokens)


def test_weights_at_the_published_init():
    s = tiny()
    dep = dsv2.deploy(s["config"], torch.Generator().manual_seed(SEED))
    w = dep.weights
    assert w["embed"].dtype == torch.bfloat16
    assert float(w["layers"][0]["ln1"]["gamma"].abs().max()) == 0.0
    assert float(w["layers"][1]["attn"]["kv_norm"].abs().max()) == 0.0
    sd = float(w["layers"][0]["moe"]["w_up"].float().std())
    assert sd == pytest.approx(0.02, rel=0.05)


def test_new_metrics_read_the_program():
    """A cell served with the span table on: the per-layer readers read
    its spans and counters (no device trace on the CPU)."""
    from repro_torch import tracing
    s = tiny()
    cell = dsv2.Cell(s["config"], s["traffic"], SEED, torch.device("cpu"))
    tracing.reset()
    tracing.enable()
    try:
        for i in range(len(cell.pool)):
            cell.batch(i, {})
    finally:
        tracing.disable()
    run = harness.Run(1.0, 1.0, 2, 4, [0.5, 0.5], {}, 0,
                      cell.flops_per_datapoint, cell.sweep_bound_s)
    try:
        got = {m: harness.reader(m)(run) for m in
               ("expert_skew", "expert_pad_share", "lm_hidden_ms", "lm_mfu")}
        t = tracing.totals()
    finally:
        tracing.reset()
    assert got["expert_pad_share"] == 0.0
    assert got["expert_skew"] >= 1.0 and got["lm_hidden_ms"] > 0
    assert 0 < got["lm_mfu"] < 100
    assert t["moe.dropped"]["count"] == 0
    assert t["lm.valid_tokens"]["count"] == sum(
        n for b in cell.pool for n in b.lens)
    assert harness.reader("lm_roofline")(run) is None     # no trace

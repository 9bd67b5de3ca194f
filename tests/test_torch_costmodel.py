"""The port's calibrated sweep-cost model (``repro_torch.impact.costmodel``)
and ``InferenceSession.cost_analysis`` on the CPU, held to the
reference's ``tests/test_costmodel.py`` contracts.

The port prices time on an H100 rather than unit-weight flops + bytes
(the module docstring says why), so the counts are its own; the
contracts are the reference's: counts populated for every routing, raw
cost nondecreasing in batch, calibrate-once, the analog floor, metered
at least unmetered, the ``bench_section`` record, and the analog latency
equal to the reference's for the same system (rtol 1e-12).  The work
functions count the crossbar products as 2·B·K·N exactly, and pricing
prepares and launches nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CoTMConfig as JConfig
from repro.core.cotm import CoTMParams as JParams
from repro.impact import IMPACTConfig as JImpactConfig
from repro.impact import build_system as jbuild
from repro_torch import kernels
from repro_torch.convert import system_from_arrays
from repro_torch.impact import RuntimeSpec, SweepCostModel, build_coresident
from repro_torch.impact.costmodel import (COPY_S, DEFAULT_BAND, LAUNCH_S,
                                          REPLAY_S, bench_section,
                                          bytes_per_sweep)
from repro_torch.kernels import work

K, N_CLAUSES, M, N_STATES = 64, 32, 4, 64
BACKENDS = ("cuda", "torch", "cuda-packed", "cuda-metered")
METERING = ("off", "fused", "staged")


@pytest.fixture(scope="module")
def systems():
    """The reference's cost-model system, and the port's copy of it."""
    cfg = JConfig(n_literals=K, n_clauses=N_CLAUSES, n_classes=M,
                  n_states=N_STATES)
    rng = np.random.default_rng(0)
    ta = np.where(rng.random((K, N_CLAUSES)) < 0.1, N_STATES + 1, N_STATES)
    w = rng.integers(-20, 20, (M, N_CLAUSES))
    jsys = jbuild(JParams(ta_state=jnp.asarray(ta, jnp.int32),
                          weights=jnp.asarray(w, jnp.int32)), cfg,
                  jax.random.key(0),
                  JImpactConfig(variability=False, finetune=False))
    d = {f: np.asarray(getattr(jsys, f)) for f in
         ("clause_g", "nonempty", "class_g", "clause_i", "class_i")}
    d.update(n_literals=K, n_clauses=N_CLAUSES, n_classes=M,
             program_energy_j=float(jsys.encode_stats["program_energy_j"]),
             erase_energy_j=float(jsys.encode_stats["erase_energy_j"]))
    return jsys, system_from_arrays(d, device="cpu")


@pytest.fixture(scope="module")
def small_system(systems):
    return systems[1]


def _spec(**kw):
    return RuntimeSpec(device="cpu", **kw)


def _coresident(small_system, metering="fused", **kw):
    combined, plan = build_coresident([small_system, small_system])
    return combined.compile(_spec(coresident=plan, metering=metering, **kw))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("metering", METERING)
def test_session_cost_analysis_is_populated(small_system, backend, metering):
    """Every routing reports nonzero flops, bytes, launches and bound."""
    for packing in ("none", "2bit"):
        sess = small_system.compile(_spec(backend=backend, metering=metering,
                                          packing=packing))
        for entry in ("predict", "infer_step"):
            ca = sess.cost_analysis(entry, 8)
            assert set(ca) == {"flops", "bytes_accessed", "launches",
                               "bound_s"}
            assert all(isinstance(v, float) and v > 0 for v in ca.values()), \
                (backend, metering, packing, entry, ca)


def test_coresident_and_feedback_costs_are_populated(small_system):
    co = _coresident(small_system)
    for entry in ("predict", "infer_step", "infer_with_report"):
        ca = co.cost_analysis(entry, 8)
        assert ca["flops"] > 0 and ca["launches"] >= 2, (entry, ca)
    ca = small_system.compile(_spec()).cost_analysis("ta_feedback", 32)
    assert ca["flops"] == 6.0 * K * N_CLAUSES * 32 and ca["launches"] == 1
    with pytest.raises(RuntimeError, match="metering='off'"):
        small_system.compile(_spec(metering="off")).cost_analysis(
            "infer_with_report", 8)


@pytest.mark.parametrize("backend", BACKENDS)
def test_estimate_raw_monotone_in_batch(small_system, backend):
    m = SweepCostModel(small_system.compile(_spec(backend=backend,
                                                  metering="off")),
                       entry="predict")
    raws = [m.estimate(B).raw for B in (4, 8, 16, 32, 128)]
    assert all(a <= b for a, b in zip(raws, raws[1:])), raws
    est = m.estimate(4)
    assert est.analog_latency_s > 0
    assert est.raw == pytest.approx(est.bound_s + est.launches * LAUNCH_S)


def test_calibration_contract(small_system):
    m = SweepCostModel(small_system.compile(_spec(metering="fused")))
    with pytest.raises(RuntimeError, match="not calibrated"):
        m.predict_s(8)
    with pytest.raises(RuntimeError, match="not calibrated"):
        m.calibration
    with pytest.raises(ValueError, match="positive"):
        m.calibrate(8, 0.0)
    m.calibrate(8, 2e-3)
    assert m.predict_s(8) == pytest.approx(2e-3)
    assert m.calibration["ref_batch"] == 8
    assert m.calibration["ref_measured_s"] == 2e-3
    want = 2e-3 * m.estimate(32).raw / m.estimate(8).raw
    assert m.predict_s(32) == pytest.approx(want)


def test_analog_floor_binds_when_host_term_vanishes(small_system):
    m = SweepCostModel(small_system.compile(_spec(backend="torch",
                                                  metering="off")),
                       entry="predict")
    m.calibrate(8, 1e-15)
    assert m.predict_s(8) == pytest.approx(m.estimate(8).analog_latency_s)


@pytest.mark.parametrize("packing", ["none", "2bit"])
def test_metered_fused_costs_at_least_unmetered(small_system, packing):
    off = SweepCostModel(small_system.compile(_spec(metering="off",
                                                    packing=packing)))
    fused = SweepCostModel(small_system.compile(_spec(metering="fused",
                                                      packing=packing)))
    for B in (8, 32, 128):
        assert fused.estimate(B).raw >= off.estimate(B).raw, B


def test_bench_section_shape_and_gateability(small_system):
    bs = (8, 32)
    results = {f"{impl}_b{B}": dict(us_per_batch=50.0 + B)
               for impl in ("torch", "cuda") for B in bs}
    metered = {f"metered_{mode}_b{B}": dict(us_per_batch=60.0 + B)
               for mode in METERING for B in bs}
    sec = bench_section(small_system, dict(results=results,
                                           metered=dict(results=metered)),
                        batch_sizes=bs)
    lo, hi = sec["band"]
    assert (lo, hi) == DEFAULT_BAND and 0.0 < lo < 1.0 < hi
    families = {"predict/torch", "predict/cuda", "infer_step/cuda-off",
                "infer_step/cuda-fused", "infer_step/cuda-staged"}
    assert set(sec["calibration"]) == families
    assert set(sec["entries"]) == {f"{f}_b{B}" for f in families
                                   for B in bs}
    for fam in families:
        ref = sec["entries"][f"{fam}_b{bs[0]}"]
        assert ref["calibration_ref"] is True
        assert ref["ratio_pred_over_meas"] == pytest.approx(1.0)
        assert ref["predicted_s"] > 0 and ref["flops"] > 0
        assert ref["launches"] > 0 and ref["bound_s"] > 0
    for B in bs:
        o = sec["orderings"][f"metered_fused_over_off_b{B}"]
        assert o["raw_cost_ratio"] >= o["must_be_at_least"] == 1.0
        assert "must_be_at_least" not in \
            sec["orderings"][f"staged_over_off_b{B}"]


def test_analog_latency_matches_reference(systems):
    jsys, tsys = systems
    m = SweepCostModel(tsys.compile(_spec()))
    assert m.estimate(8).analog_latency_s == pytest.approx(
        float(jsys._grid_latency()), rel=1e-12)


@pytest.mark.parametrize("B,K_,N", [(1, 1, 1), (8, 64, 32), (128, 1568, 512),
                                    (37, 300, 77)])
def test_work_counts_crossbar_products(B, K_, N):
    flops, moved = work.crossbar_mvm(B, K_, N)
    assert flops == 2.0 * B * K_ * N
    assert moved == 4.0 * (B * K_ + K_ * N + B * N)


def test_staged_and_fused_flops_are_their_products(small_system):
    B = 16
    staged = small_system.compile(_spec(metering="staged"))
    calls = staged.mvm_calls()
    ca = staged.cost_analysis("infer_step", B)
    assert ca["flops"] == sum(2.0 * B * k * n for k, n in calls)
    assert ca["launches"] == sum(work.launches_mvm(B, k, n)
                                 for k, n in calls)
    off = small_system.compile(_spec(metering="off"))
    n_ne, _ = off._needed()
    R, C, tr, tc = small_system.clause_i.shape
    live = min(tr, K)
    assert off.cost_analysis("predict", B)["flops"] == (
        2.0 * B * live * n_ne + 2.0 * B * n_ne * M)
    assert n_ne == int(small_system.nonempty.sum())


@pytest.mark.parametrize("coresident", [False, True])
@pytest.mark.parametrize("metering", METERING)
@pytest.mark.parametrize("packing", ["none", "2bit"])
def test_cost_routes_match_the_trace(small_system, metering, packing,
                                     coresident):
    """The primitives ``cost_analysis`` prices are the kernels the entry's
    trace launches, in order (the staged dequantize is aten work), on
    every route ``route()`` answers: a co-resident session's entries too."""
    sess = (_coresident(small_system, metering, packing=packing) if coresident
            else small_system.compile(_spec(metering=metering,
                                            packing=packing)))
    entries = ("predict", "infer_step") + (
        ("infer_with_report",) if sess.meters_energy else ())
    for entry in entries:
        priced = [i.kernel for i in sess.work_items(entry, 8)
                  if i.kernel != "dequant_clause"]
        traced = [ln.split("(")[0].split()[1]
                  for ln in sess.ir_text(entry, 8).splitlines()
                  if ln.startswith("kernel ")]
        assert priced == traced, (entry, priced, traced)


def test_pricing_prepares_and_launches_nothing(small_system):
    sess = small_system.compile(_spec(metering="fused", capacity=8,
                                      batch_sizes=(4,)))
    before = (sess.trace_count, sess.compiled_shapes(),
              kernels.launch_counts())
    m = SweepCostModel(sess)
    m.calibrate(8, 1e-3)
    for B in (4, 8, 16, 256):
        sess.cost_analysis("predict", B)
        m.predict_s(B)
        bytes_per_sweep(sess, "infer_step", B)
    assert (sess.trace_count, sess.compiled_shapes(),
            kernels.launch_counts()) == before


def test_bytes_per_sweep_sees_the_packed_operand(small_system):
    f32 = bytes_per_sweep(small_system.compile(_spec(metering="fused")),
                          "infer_step", 32)
    packed = bytes_per_sweep(small_system.compile(
        _spec(metering="fused", packing="2bit")), "infer_step", 32)
    assert packed["input_bytes"] < f32["input_bytes"]
    assert packed["bytes_accessed"] < f32["bytes_accessed"]
    assert packed["flops"] == f32["flops"]
    staged = bytes_per_sweep(small_system.compile(
        _spec(metering="staged", packing="2bit")), "infer_step", 32)
    assert staged["bytes_accessed"] > packed["bytes_accessed"]


def test_needed_columns_follow_refresh(small_system):
    """The data-dependent column counts are read once per
    ``refresh_operands`` and follow the operands."""
    sess = small_system.compile(_spec(metering="fused"))
    n_ne, n_meter = sess._needed()
    assert n_ne <= n_meter <= small_system.clause_i.shape[1] * \
        small_system.clause_i.shape[3]
    assert sess._needed() is sess._needed()
    sess.refresh_operands()
    assert sess._needed() == (n_ne, n_meter)
    ne = torch.zeros_like(small_system.nonempty)
    assert work.needed_columns(ne, ne) == (0, 0)


@pytest.mark.parametrize("entry,copies", [("predict", 1), ("infer_step", 2),
                                          ("ta_feedback", 7)])
def test_graphed_entries_price_one_replay(small_system, monkeypatch, entry,
                                          copies):
    """On a card each call replays one CUDA graph: its host part is one
    replay and one copy an operand, whatever its launches, which stay
    the kernel count."""
    sess = small_system.compile(_spec(metering="staged"))
    eager = SweepCostModel(sess, entry).estimate(32)
    assert not eager.graphed
    assert eager.raw == pytest.approx(eager.bound_s
                                      + eager.launches * LAUNCH_S)
    monkeypatch.setattr(type(sess), "graphed", property(lambda s: True))
    est = SweepCostModel(sess, entry).estimate(32)
    assert est.graphed and est.copies == copies
    assert est.launches == eager.launches > 0
    assert est.raw == pytest.approx(est.bound_s + REPLAY_S + copies * COPY_S)

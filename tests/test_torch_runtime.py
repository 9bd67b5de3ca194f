"""The port's compiled session (``predict`` / ``infer_step`` /
``infer_with_report``) on ``device="cpu"`` against the JAX session on the
same programmed system, under every metering mode.

Contracts (the reference's): argmax exact; invalid lanes predict -1 and
bill exactly 0; per-lane clause energies rtol 1e-3 and class energies
rtol 1e-5 (reassociated f32 current sums); ``EnergyReport`` fields rtol
1e-5, with datapoints / ops / latency exact; ``infer_with_report`` raises
under ``metering="off"``.  The ``"cuda"`` backend on CPU tensors runs the
plain versions, so both registered backends are held to the reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.impact import IMPACTConfig as JConfig
from repro.impact import RuntimeSpec as JSpec
from repro.impact.pipeline import IMPACTSystem as JSystem
from repro_torch.convert import system_from_arrays
from repro_torch.impact import RuntimeSpec, build_coresident
from repro_torch.impact.yflash import read_current

# (B, K, n, M, R, tr, C, tc, S, sr): a sharded ragged grid and a one-tile
# grid whose class tile is taller than the clause tile.
LAYOUTS = [(37, 300, 77, 3, 2, 150, 3, 30, 5, 16),
           (16, 120, 40, 10, 1, 128, 1, 64, 1, 96)]
METERING = ["off", "staged", "fused"]
BACKENDS = ["cuda", "torch"]


def _arrays(B, K, n, M, R, tr, C, tc, S, sr, seed=0):
    rng = np.random.default_rng(seed)
    include = rng.random((R * tr, C * tc)) < min(0.05, 4.0 / K)
    include[K:, :] = False
    include[:, n:] = False
    g = np.where(include,
                 2.5e-6 * (1 + 0.05 * rng.standard_normal(include.shape)),
                 0.9e-9 * (1 + 0.05 * rng.standard_normal(include.shape)))
    clause_g = np.ascontiguousarray(
        g.reshape(R, tr, C, tc).transpose(0, 2, 1, 3), np.float32)
    wg = rng.uniform(1e-9, 2.5e-6, (S, sr, M))
    wg *= (np.arange(S * sr).reshape(S, sr, 1) < n)
    class_g = wg.astype(np.float32)
    d = dict(clause_g=clause_g, class_g=class_g,
             clause_i=read_current(torch.from_numpy(clause_g)).numpy(),
             class_i=read_current(torch.from_numpy(class_g)).numpy(),
             nonempty=include[:, :C * tc].any(axis=0), n_literals=K,
             n_clauses=n, n_classes=M, program_energy_j=1.5e-3,
             erase_energy_j=2.5e-9)
    lits = rng.random((B, K)) < 0.5
    valid = np.ones(B, bool)
    valid[rng.choice(B, size=B // 4, replace=False)] = False
    return d, lits, valid


@pytest.fixture(scope="module", params=range(len(LAYOUTS)))
def pair(request):
    d, lits, valid = _arrays(*LAYOUTS[request.param], seed=request.param)
    jsys = JSystem(
        clause_g=jnp.asarray(d["clause_g"]), nonempty=jnp.asarray(
            d["nonempty"]), class_g=jnp.asarray(d["class_g"]),
        clause_i=jnp.asarray(d["clause_i"]), class_i=jnp.asarray(
            d["class_i"]), n_literals=d["n_literals"],
        n_clauses=d["n_clauses"], n_classes=d["n_classes"], cfg=JConfig(),
        encode_stats=dict(program_energy_j=d["program_energy_j"],
                          erase_energy_j=d["erase_energy_j"]))
    return jsys, system_from_arrays(d, device="cpu"), lits, valid


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("metering", METERING)
def test_session_matches_jax(pair, backend, metering):
    jsys, tsys, lits, valid = pair
    js = jsys.compile(JSpec(backend="xla", metering=metering))
    ts = tsys.compile(RuntimeSpec(backend=backend, metering=metering,
                                  device="cpu"))
    want = js.predict(jnp.asarray(lits))
    got = ts.predict(lits)
    np.testing.assert_array_equal(got.predictions.numpy(),
                                  np.asarray(want.predictions))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6)

    w_step = js.infer_step(jnp.asarray(lits), jnp.asarray(valid))
    g_step = ts.infer_step(lits, valid)
    preds = g_step.predictions.numpy()
    np.testing.assert_array_equal(preds, np.asarray(w_step.predictions))
    assert (preds[~valid] == -1).all() and (preds[valid] >= 0).all()
    for lane_t, lane_j, rtol in (
            (g_step.e_clause_lanes, w_step.e_clause_lanes, 1e-3),
            (g_step.e_class_lanes, w_step.e_class_lanes, 1e-5)):
        lane_t = lane_t.numpy()
        assert (lane_t[~valid] == 0.0).all()
        np.testing.assert_allclose(lane_t, np.asarray(lane_j), rtol=rtol)
        if metering == "off":
            assert (lane_t == 0.0).all()

    if metering == "off":
        with pytest.raises(RuntimeError, match="metering='off'"):
            ts.infer_with_report(lits)
        return
    w_rep = js.infer_with_report(jnp.asarray(lits), valid=valid)
    g_rep = ts.infer_with_report(lits, valid=valid)
    np.testing.assert_array_equal(g_rep.predictions.numpy(),
                                  np.asarray(w_rep.predictions))
    rt, rj = g_rep.report, w_rep.report
    assert rt.read_energy_j > 0
    for f in ("read_energy_j", "clause_energy_j", "class_energy_j"):
        np.testing.assert_allclose(getattr(rt, f), getattr(rj, f),
                                   rtol=1e-5)
    for f in ("program_energy_j", "erase_energy_j", "latency_s",
              "ops_crosspoint", "datapoints", "area_mm2", "write_energy_j"):
        assert getattr(rt, f) == getattr(rj, f), f
    assert rt.datapoints == int(valid.sum())


def test_fused_and_staged_meters_agree(pair):
    _, tsys, lits, valid = pair
    fused = tsys.compile(RuntimeSpec(metering="fused", device="cpu"))
    staged = tsys.compile(RuntimeSpec(metering="staged", device="cpu"))
    a, b = fused.infer_step(lits, valid), staged.infer_step(lits, valid)
    assert torch.equal(a.predictions, b.predictions)
    np.testing.assert_allclose(a.e_clause_lanes, b.e_clause_lanes, rtol=1e-3)
    np.testing.assert_allclose(a.e_class_lanes, b.e_class_lanes, rtol=1e-5)


def test_session_shapes_are_prepared_once(pair):
    _, tsys, lits, valid = pair
    B = lits.shape[0]
    spec = RuntimeSpec(metering="fused", capacity=B, batch_sizes=(4, 8),
                       device="cpu")
    sess = tsys.compile(spec)
    assert tsys.compile(spec) is sess
    assert sess.compiled_shapes() == sorted(
        [("infer_step", B), ("predict", 4), ("predict", 8)])
    assert sess.trace_count == 3
    for _ in range(3):
        sess.infer_step(lits, valid)
        sess.predict(lits[:4])
    assert sess.trace_count == 3
    sess.infer_with_report(lits)
    assert sess.is_compiled("infer_with_report", B)
    assert sess.trace_count == 4
    sess.warm(8, "infer_with_report")
    assert sess.trace_count == 5
    with pytest.raises(ValueError, match="valid shape"):
        sess.infer_step(lits, valid[:-1])
    with pytest.raises(ValueError, match="unknown entry"):
        sess.warm(4, "train")
    sess.warm(8, "ta_feedback")
    assert sess.trace_count == 6
    assert "fused" in repr(sess)


@pytest.mark.parametrize("packing", ["none", "2bit"])
def test_coresident_specs_compile(packing):
    """A ``CoResidentPlan`` compiles, alone and with ``packing="2bit"``
    (the reference's co-resident specs; ``tests/test_torch_coresident.py``
    holds the sessions against it)."""
    members = [system_from_arrays(_arrays(4, 24, 8, 3 + i, 1, 24, 1, 8, 1,
                                          8, seed=i)[0], device="cpu")
               for i in range(2)]
    combined, plan = build_coresident(members)
    sess = combined.compile(RuntimeSpec(device="cpu", packing=packing,
                                        capacity=4, coresident=plan))
    assert sess.coresident is plan and sess.packed == (packing == "2bit")
    assert sess.trace_count == 1 and sess.is_compiled("infer_step", 4)
    lits = np.ones((4, combined.n_literals), np.int8)
    res = sess.infer_step(lits, np.ones(4, bool),
                          model_ids=np.array([0, 1, 0, 1], np.int32))
    assert (res.predictions.numpy() >= 0).all()
    with pytest.raises(TypeError, match="CoResidentPlan"):
        RuntimeSpec(device="cpu", packing=packing, coresident=object())


@pytest.mark.parametrize("kwargs,exc", [
    (dict(topology=object()), TypeError),
    (dict(metering="always"), ValueError),
    (dict(packing="4bit"), ValueError),
    (dict(capacity=0), ValueError),
    (dict(batch_sizes=(0,)), ValueError),
])
def test_unsupported_spec_values_raise(kwargs, exc):
    with pytest.raises(exc) as info:
        RuntimeSpec(device="cpu", **kwargs)
    if exc is TypeError:
        assert "Topology" in str(info.value)


def test_spec_defaults_follow_the_reference():
    spec = RuntimeSpec()
    assert (spec.backend, spec.metering, spec.device) == ("cuda", "staged",
                                                         "cuda")
    assert RuntimeSpec(device=torch.device("cpu")) == RuntimeSpec(
        device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        system_from_arrays(_arrays(*LAYOUTS[1])[0], device="cpu").compile(
            RuntimeSpec(backend="pallas", device="cpu"))

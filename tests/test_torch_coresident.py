"""The port's crossbar co-residency (``build_coresident``,
``CoResidentPlan``, ``RuntimeSpec(coresident=...)`` sessions, the
co-resident oracles and the staged composition the sessions serve) held
against the JAX reference on the same numpy inputs, and the
``"cuda-metered"`` backend and ``unregister_backend`` of the registry.

The members are the reference's own small single-tile systems
(``test_fused_impact._make_system``), carried across as arrays.  The JAX
side runs its ``"xla"`` co-resident session; the port's ``"torch"`` and
``"cuda"`` backends run on CPU tensors (the ``"cuda"`` wrappers take the
plain versions there), so both routings are held to the reference.

Contracts (the reference's ``tests/test_model_zoo.py`` and
``tests/test_energy_invariants.py``): the combined grid bit for bit; the
lane mask, fired bits and predictions exact; scores rtol 1e-6 and exactly
0 outside each lane's class span; clause meters rtol 1e-3 and class meters
rtol 1e-5 (reassociated f32 current sums); invalid lanes predict -1 and
bill exactly 0; the f64 sum of the tenants' lane bills equals the batch
meter (rel 1e-12, as the reference holds it).  Under ``packing="2bit"``
the two sides pack the clause operand each on its own; the levels differ
by up to 1.4e-6 relative (``tests/test_torch_packing.py``), which the
clause-meter tolerance covers, and the fired bits do not move.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.impact import RuntimeSpec as JSpec
from repro.impact import build_coresident as jbuild_coresident
from repro.kernels import ref as jref
from repro_torch.convert import system_from_arrays
from repro_torch.impact import (CoResidentPlan, RuntimeSpec, TenantSpan,
                                build_coresident)
from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
from repro_torch.kernels import backends, packing, ref

from test_fused_impact import _make_system

N_TENANTS, LANES = 3, 8
BACKENDS = ["torch", "cuda"]
PACKINGS = ["none", "2bit"]
METERING = ["off", "staged", "fused"]
SYSTEM_FIELDS = ("clause_g", "nonempty", "class_g", "clause_i", "class_i")


def to_port(jsys):
    """The reference's programmed system as the port's, on the CPU."""
    d = {k: np.asarray(getattr(jsys, k)) for k in SYSTEM_FIELDS}
    d.update(n_literals=jsys.n_literals, n_clauses=jsys.n_clauses,
             n_classes=jsys.n_classes,
             program_energy_j=jsys.encode_stats["program_energy_j"],
             erase_energy_j=jsys.encode_stats["erase_energy_j"])
    return system_from_arrays(d, device="cpu")


def members(n_tenants=N_TENANTS, K=12, n=6, seed0=0, density=0.2):
    """Single-tile members with distinct class counts (a routing fault
    that mixes tenants cannot agree by chance), as (JAX, port) pairs."""
    js = [_make_system(4, K, n, 3 + i, 1, K, 1, n, 1, K, seed=seed0 + i,
                       density=density)[1] for i in range(n_tenants)]
    return js, [to_port(s) for s in js]


def mixed_batch(plan, B=LANES, n_invalid=2, seed=0):
    """A slot buffer whose lanes cycle the tenants: each lane drives its
    tenant's literal rows (the rest float at 1); the last ``n_invalid``
    lanes are free."""
    rng = np.random.default_rng(seed)
    K_tot = plan.spans[-1].lit_hi
    lits = np.ones((B, K_tot), np.int8)
    mids = np.zeros((B,), np.int32)
    valid = np.zeros((B,), bool)
    rows = []
    for i in range(B):
        t = i % plan.n_tenants
        sp = plan.spans[t]
        row = rng.integers(0, 2, size=sp.lit_hi - sp.lit_lo).astype(np.int8)
        lits[i, sp.lit_lo:sp.lit_hi] = row
        mids[i] = t
        valid[i] = i < B - n_invalid
        rows.append((t, row))
    return lits, mids, valid, rows


@pytest.fixture(scope="module")
def grid():
    js, ts = members()
    jcomb, jplan = jbuild_coresident(js)
    tcomb, tplan = build_coresident(ts)
    return dict(js=js, ts=ts, jcomb=jcomb, jplan=jplan, tcomb=tcomb,
                tplan=tplan, batch=mixed_batch(tplan))


@pytest.fixture(scope="module")
def jax_runs(grid):
    """The reference's co-resident session on the mixed batch, for every
    packing and metering: (predict, infer_step, infer_with_report)."""
    lits, mids, valid, _ = grid["batch"]
    out = {}
    for p in PACKINGS:
        for m in METERING:
            js = grid["jcomb"].compile(JSpec(backend="xla", metering=m,
                                             packing=p,
                                             coresident=grid["jplan"]))
            jl, jm, jv = (jnp.asarray(lits), jnp.asarray(mids),
                          jnp.asarray(valid))
            out[p, m] = (js.predict(jl, model_ids=jm),
                         js.infer_step(jl, jv, model_ids=jm),
                         None if m == "off" else js.infer_with_report(
                             jl, valid=jv, model_ids=jm))
    return out


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


# -- build_coresident ---------------------------------------------------------

def test_build_coresident_matches_reference(grid):
    """Dims, spans and every combined array bit for bit as the reference
    builds them from the same members; off-block cells exactly 0."""
    ts, tcomb, tplan = grid["ts"], grid["tcomb"], grid["tplan"]
    jcomb, jplan = grid["jcomb"], grid["jplan"]
    assert (tcomb.n_literals, tcomb.n_clauses, tcomb.n_classes) == (
        sum(s.n_literals for s in ts), sum(s.n_clauses for s in ts),
        sum(s.n_classes for s in ts))
    assert (tcomb.n_literals, tcomb.n_clauses, tcomb.n_classes) == (
        jcomb.n_literals, jcomb.n_clauses, jcomb.n_classes)
    assert [tuple(vars(s).values()) for s in tplan.spans] == [
        tuple(vars(s).values()) for s in jplan.spans]
    for k in SYSTEM_FIELDS:
        got = getattr(tcomb, k).numpy()
        want = np.asarray(getattr(jcomb, k))
        assert got.shape == want.shape and got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    ci = tcomb.clause_i[0, 0].numpy().copy()
    cs = tcomb.class_i[0].numpy().copy()
    for sp in tplan.spans:
        assert ci[sp.lit_lo:sp.lit_hi, sp.col_lo:sp.col_hi].any()
        ci[sp.lit_lo:sp.lit_hi, sp.col_lo:sp.col_hi] = 0.0
        cs[sp.col_lo:sp.col_hi, sp.cls_lo:sp.cls_hi] = 0.0
    assert not ci.any() and not cs.any()
    assert tcomb.encode_stats == dict(
        program_energy_j=jcomb.encode_stats["program_energy_j"],
        erase_energy_j=jcomb.encode_stats["erase_energy_j"],
        coresident_members=N_TENANTS)
    assert tcomb.device == torch.device("cpu")


def test_build_coresident_rejects_sharded_members():
    _, (small,) = members(1)
    sharded = to_port(_make_system(4, 24, 12, 3, 2, 12, 2, 6, 1, 24)[1])
    with pytest.raises(ValueError, match="single-tile"):
        build_coresident([small, sharded])
    with pytest.raises(ValueError, match="at least one"):
        build_coresident([])


def test_build_coresident_rejects_oversized_grid():
    _, (big,) = members(1)
    n_fit = big.cfg.max_tile_cols // big.n_clauses
    build_coresident([big] * n_fit)
    with pytest.raises(ValueError, match="does not fit"):
        build_coresident([big] * (n_fit + 1))


def test_coresident_plan_validates_spans(grid):
    with pytest.raises(ValueError):
        TenantSpan(0, 0, 0, 4, 0, 2)            # empty literal span
    with pytest.raises(ValueError):
        TenantSpan(0, 4, 3, 2, 0, 2)            # negative clause span
    with pytest.raises(ValueError, match="at least one tenant"):
        CoResidentPlan(spans=())
    a = TenantSpan(0, 4, 0, 2, 0, 2)
    with pytest.raises(ValueError, match="non-overlapping"):
        CoResidentPlan(spans=(a, TenantSpan(2, 8, 2, 4, 2, 4)))
    plan = CoResidentPlan(spans=[a, TenantSpan(4, 8, 2, 4, 2, 4)])
    assert isinstance(plan.spans, tuple) and hash(plan) == hash(
        CoResidentPlan(spans=plan.spans))
    assert plan.literal_spans == ((0, 4), (4, 8))
    assert plan.clause_spans == ((0, 2), (2, 4))
    assert plan.class_spans == ((0, 2), (2, 4))
    _, (one,) = members(1)                       # K=12, n=6, M=3
    CoResidentPlan(spans=(TenantSpan(0, 12, 0, 6, 0, 3),)).validate_against(
        one)
    with pytest.raises(ValueError, match="exceeds the combined grid"):
        CoResidentPlan(spans=(TenantSpan(0, 12, 0, 6, 0, 4),)
                       ).validate_against(one)
    with pytest.raises(ValueError, match="exceeds"):
        one.compile(RuntimeSpec(device="cpu", coresident=grid["tplan"]))


# -- oracles and primitives ---------------------------------------------------

def _jax_core(grid):
    lits, mids, _, _ = grid["batch"]
    j = grid["jcomb"]
    spans = jnp.asarray(grid["jplan"].clause_spans, jnp.int32)
    return (jnp.asarray(lits), j.clause_i, j.nonempty, j.class_i,
            jnp.asarray(mids), spans)


def _port_core(grid):
    lits, mids, _, _ = grid["batch"]
    t = grid["tcomb"]
    spans = torch.tensor(grid["tplan"].clause_spans, dtype=torch.int32)
    return (torch.from_numpy(lits), t.clause_i, t.nonempty, t.class_i,
            torch.from_numpy(mids), spans)


def test_coresident_refs_match_jax(grid):
    """The lane mask and the gated fired bits exactly, scores and meters
    at the reference's tolerances, against the JAX oracles."""
    j, t = _jax_core(grid), _port_core(grid)
    n = grid["tcomb"].n_clauses
    mask = ref.coresident_lane_mask(t[4], t[5], n)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jref.coresident_lane_mask(j[4], j[5], n)))
    assert mask.sum(1).tolist() == [grid["ts"][m].n_clauses
                                    for m in t[4].tolist()]
    fired = ref.impact_clause_bits_ref(*t[:3], thresh=TH)[0] & mask
    j_fired = jnp.logical_and(
        jref.impact_clause_bits_ref(*j[:3], thresh=TH)[0],
        jref.coresident_lane_mask(j[4], j[5], n))
    np.testing.assert_array_equal(fired.numpy(), np.asarray(j_fired))
    assert fired.any()
    _close(ref.fused_impact_coresident_ref(*t, thresh=TH),
           jref.fused_impact_coresident_ref(*j, thresh=TH), 1e-6)
    got = ref.fused_impact_coresident_metered_ref(*t, thresh=TH)
    want = jref.fused_impact_coresident_metered_ref(*j, thresh=TH)
    for g, w, rtol in zip(got, want, (1e-6, 1e-3, 1e-5)):
        _close(g, w, rtol)


@pytest.mark.parametrize("backend", BACKENDS)
def test_coresident_primitives_match_reference(grid, backend):
    """The staged composition a co-resident session serves on each backend
    (its ``impact_clause_bits`` / ``impact_class_scores`` pair, the fired
    bits gated by ``ref.coresident_lane_mask``) against the JAX oracles:
    on the f32 operand, and on the session's own packed operand against
    the oracle on its dequantized currents."""
    t, j = _port_core(grid), _jax_core(grid)
    tr = grid["tcomb"].clause_i.shape[2]
    for p in PACKINGS:
        sess = grid["tcomb"].compile(RuntimeSpec(
            backend=backend, packing=p, device="cpu",
            coresident=grid["tplan"]))
        jc = j
        if p == "2bit":
            deq = packing.dequant_clause(*sess._packed, tr)
            jc = (j[0], jnp.asarray(deq.numpy()), *j[2:])
        assert torch.equal(sess._co_lane_cols(t[4]), ref.coresident_lane_mask(
            t[4], t[5], grid["tcomb"].n_clauses))
        scores = sess._staged_core(t[0], None, t[4])
        _close(scores, jref.fused_impact_coresident_ref(*jc, thresh=TH),
               1e-6)
        metered = sess._staged_core(
            t[0], torch.ones(t[0].shape[0], dtype=torch.bool), t[4])
        assert torch.equal(metered[0], scores)
        want = jref.fused_impact_coresident_metered_ref(*jc, thresh=TH)
        for g, w, rtol in zip(metered, want, (1e-6, 1e-3, 1e-5)):
            _close(g, w, rtol)


# -- sessions -------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("packing", PACKINGS)
@pytest.mark.parametrize("metering", METERING)
def test_coresident_session_matches_jax(grid, jax_runs, backend, packing,
                                        metering):
    tcomb, tplan = grid["tcomb"], grid["tplan"]
    lits, mids, valid, _ = grid["batch"]
    w_pred, w_step, w_rep = jax_runs[packing, metering]
    ts = tcomb.compile(RuntimeSpec(backend=backend, metering=metering,
                                   packing=packing, capacity=LANES,
                                   coresident=tplan, device="cpu"))
    assert ts.trace_count == 1
    got = ts.predict(lits, model_ids=mids)
    np.testing.assert_array_equal(got.predictions.numpy(),
                                  np.asarray(w_pred.predictions))
    _close(got.scores, w_pred.scores, 1e-6)
    # Zero cross-tenant leakage: every score outside the lane's own class
    # span is exactly 0.
    for b, m in enumerate(mids):
        sp = tplan.spans[m]
        row = got.scores[b].clone()
        row[sp.cls_lo:sp.cls_hi] = 0.0
        assert not row.any(), b
        assert 0 <= int(got.predictions[b]) < sp.cls_hi - sp.cls_lo

    step = ts.infer_step(lits, valid, model_ids=mids)
    preds = step.predictions.numpy()
    np.testing.assert_array_equal(preds, np.asarray(w_step.predictions))
    assert (preds[~valid] == -1).all() and (preds[valid] >= 0).all()
    for lane_t, lane_j, rtol in ((step.e_clause_lanes,
                                  w_step.e_clause_lanes, 1e-3),
                                 (step.e_class_lanes, w_step.e_class_lanes,
                                  1e-5)):
        assert (lane_t.numpy()[~valid] == 0.0).all()
        _close(lane_t, lane_j, rtol)
        if metering == "off":
            assert (lane_t.numpy() == 0.0).all()
    if metering == "off":
        with pytest.raises(RuntimeError, match="metering='off'"):
            ts.infer_with_report(lits, valid=valid, model_ids=mids)
    else:
        g_rep = ts.infer_with_report(lits, valid=valid, model_ids=mids)
        np.testing.assert_array_equal(g_rep.predictions.numpy(),
                                      np.asarray(w_rep.predictions))
        for f, rtol in (("clause_energy_j", 1e-3), ("class_energy_j", 1e-5),
                        ("program_energy_j", 0.0), ("latency_s", 1e-12)):
            np.testing.assert_allclose(getattr(g_rep.report, f),
                                       getattr(w_rep.report, f), rtol=rtol)
        assert g_rep.report.datapoints == w_rep.report.datapoints
        assert g_rep.report.ops_crosspoint == w_rep.report.ops_crosspoint
    # Serving the prepared shapes again adds no preparation: model_ids add
    # none, as for a single-tenant session.
    before = ts.trace_count
    ts.infer_step(lits, valid, model_ids=mids)
    ts.predict(lits, model_ids=mids)
    assert ts.trace_count == before == (2 if metering == "off" else 3)


@pytest.mark.parametrize("backend,packing", [
    ("torch", "none"), ("cuda", "none"), ("cuda", "2bit"),
    ("cuda-packed", "2bit")])
def test_coresident_session_matches_standalone(grid, backend, packing):
    """Each lane predicts what its tenant's standalone session predicts,
    with the same scores on its own class span."""
    ts, tcomb, tplan = grid["ts"], grid["tcomb"], grid["tplan"]
    lits, mids, valid, rows = grid["batch"]
    sess = tcomb.compile(RuntimeSpec(backend=backend, packing=packing,
                                     capacity=LANES, coresident=tplan,
                                     device="cpu"))
    got = sess.predict(lits, model_ids=mids)
    res = sess.infer_step(lits, valid, model_ids=mids)
    for b, (t, row) in enumerate(rows):
        solo = ts[t].compile(RuntimeSpec(backend=backend, packing=packing,
                                         device="cpu")).predict(row[None])
        sp = tplan.spans[t]
        assert int(got.predictions[b]) == int(solo.predictions[0])
        _close(got.scores[b, sp.cls_lo:sp.cls_hi], solo.scores[0], 1e-6)
        if valid[b]:
            assert int(res.predictions[b]) == int(solo.predictions[0])


def test_coresident_session_requires_model_ids(grid):
    tcomb, tplan = grid["tcomb"], grid["tplan"]
    sess = tcomb.compile(RuntimeSpec(backend="torch", capacity=4,
                                     coresident=tplan, device="cpu"))
    lits = np.ones((4, tcomb.n_literals), np.int8)
    ok = np.array([0, 1, 2, 0], np.int32)
    with pytest.raises(ValueError, match="model_ids"):
        sess.infer_step(lits, np.ones((4,), bool))
    with pytest.raises(ValueError, match="model_ids"):
        sess.predict(lits)
    with pytest.raises(ValueError, match="model_ids"):
        sess.infer_with_report(lits)
    with pytest.raises(ValueError, match="shape"):
        sess.predict(lits, model_ids=ok[:3])
    with pytest.raises(ValueError, match=r"\[0, 3\)"):
        sess.predict(lits, model_ids=np.array([0, 1, 3, 0], np.int32))
    with pytest.raises(ValueError, match=r"\[0, 3\)"):
        sess.predict(lits, model_ids=np.array([0, -1, 2, 0], np.int32))
    with pytest.raises(ValueError, match="integers"):
        sess.predict(lits, model_ids=ok.astype(np.float32))
    assert sess.predict(lits, model_ids=torch.from_numpy(ok)).predictions \
        .shape == (4,)
    plain = grid["ts"][0].compile(RuntimeSpec(backend="torch", capacity=4,
                                              device="cpu"))
    with pytest.raises(ValueError, match="co-resident"):
        plain.infer_step(np.ones((4, grid["ts"][0].n_literals), np.int8),
                         np.ones((4,), bool), model_ids=ok)


@pytest.mark.parametrize("packing", PACKINGS)
def test_coresident_input_bytes_match_jax(grid, packing):
    """``input_bytes`` counts the (B,) int32 model ids, as the reference
    does, on top of the single-tenant count."""
    ts = grid["tcomb"].compile(RuntimeSpec(
        packing=packing, coresident=grid["tplan"], device="cpu"))
    js = grid["jcomb"].compile(JSpec(backend="xla", packing=packing,
                                     coresident=grid["jplan"]))
    plain = grid["tcomb"].compile(RuntimeSpec(packing=packing,
                                              device="cpu"))
    for entry in ("predict", "infer_step", "infer_with_report"):
        assert ts.input_bytes(entry, LANES) == js.input_bytes(entry, LANES)
        assert ts.input_bytes(entry, LANES) == plain.input_bytes(
            entry, LANES) + 4 * LANES


# -- billing (tests/test_energy_invariants.py) ---------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("metering", ["staged", "fused"])
def test_coresident_tenant_bills_sum_to_batch_meter(grid, backend, metering):
    """The f64 sum of every tenant's lane bills equals the shared batch
    meter; padded lanes bill exactly 0 and predict -1; the report audits
    the same joules."""
    lits, mids, valid, rows = grid["batch"]
    sess = grid["tcomb"].compile(RuntimeSpec(
        backend=backend, metering=metering, capacity=LANES,
        coresident=grid["tplan"], device="cpu"))
    res = sess.infer_step(lits, valid, model_ids=mids)
    e_cl = res.e_clause_lanes.numpy().astype(np.float64)
    e_cs = res.e_class_lanes.numpy().astype(np.float64)
    np.testing.assert_array_equal(e_cl[~valid], 0.0)
    np.testing.assert_array_equal(e_cs[~valid], 0.0)
    assert (res.predictions.numpy()[~valid] == -1).all()
    per_tenant = {t: 0.0 for t in range(N_TENANTS)}
    for i, (t, _) in enumerate(rows):
        per_tenant[t] += e_cl[i] + e_cs[i]
    batch_meter = e_cl.sum() + e_cs.sum()
    assert all(v > 0 for v in per_tenant.values())
    np.testing.assert_allclose(sum(per_tenant.values()), batch_meter,
                               rtol=1e-12, atol=0.0)
    rep = sess.infer_with_report(lits, valid=valid, model_ids=mids).report
    np.testing.assert_allclose(rep.read_energy_j, batch_meter, rtol=1e-5,
                               atol=1e-30)
    assert rep.datapoints == int(valid.sum())


def test_coresident_lane_bills_match_standalone_sessions(grid):
    """Tenant purity: each lane's bill on the shared grid equals the bill
    its row draws on its tenant's standalone session (rtol 1e-6: the
    shared grid sums extra exact zeros in another order)."""
    lits, mids, valid, rows = grid["batch"]
    sess = grid["tcomb"].compile(RuntimeSpec(
        backend="torch", metering="staged", capacity=LANES,
        coresident=grid["tplan"], device="cpu"))
    res = sess.infer_step(lits, valid, model_ids=mids)
    e = (res.e_clause_lanes.numpy().astype(np.float64)
         + res.e_class_lanes.numpy().astype(np.float64))
    for i, (t, row) in enumerate(rows):
        if not valid[i]:
            continue
        solo = grid["ts"][t].compile(RuntimeSpec(
            backend="torch", metering="staged", capacity=1, device="cpu"))
        r = solo.infer_step(row[None, :], np.ones((1,), bool))
        want = float(r.e_clause_lanes[0]) + float(r.e_class_lanes[0])
        np.testing.assert_allclose(e[i], want, rtol=1e-6, atol=1e-30)


# -- registry: "cuda-metered" and unregister_backend ---------------------------

@pytest.mark.parametrize("packing_", PACKINGS)
@pytest.mark.parametrize("metering", METERING)
def test_cuda_metered_backend_serves_like_cuda_and_jax(grid, metering,
                                                       packing_):
    """``"cuda-metered"`` predicts what ``"cuda"`` and the reference's
    ``"xla"`` session predict (its ``fused_impact`` is the metered
    kernel's scores), with the same scores and lane bills; packed or not,
    each entry launches the kernels ``route()`` prices (every fused call
    the metered kernel)."""
    jsys, tsys = grid["js"][2], grid["ts"][2]
    rng = np.random.default_rng(5)
    lits = rng.integers(0, 2, (LANES, tsys.n_literals)).astype(np.int8)
    valid = np.arange(LANES) < LANES - 2
    cm = tsys.compile(RuntimeSpec(backend="cuda-metered", metering=metering,
                                  packing=packing_, device="cpu"))
    cu = tsys.compile(RuntimeSpec(backend="cuda", metering=metering,
                                  packing=packing_, device="cpu"))
    js = jsys.compile(JSpec(backend="xla", metering=metering,
                            packing=packing_))
    for entry in ("predict", "infer_step"):
        priced = [i.kernel for i in cm.work_items(entry, LANES)
                  if i.kernel != "dequant_clause"]
        traced = [ln.split("(")[0].split()[1]
                  for ln in cm.ir_text(entry, LANES).splitlines()
                  if ln.startswith("kernel ")]
        assert priced == traced, (entry, priced, traced)
    got, want = cm.predict(lits), cu.predict(lits)
    assert torch.equal(got.predictions, want.predictions)
    assert torch.equal(got.scores, want.scores)
    np.testing.assert_array_equal(
        got.predictions.numpy(),
        np.asarray(js.predict(jnp.asarray(lits)).predictions))
    a, b = cm.infer_step(lits, valid), cu.infer_step(lits, valid)
    assert torch.equal(a.predictions, b.predictions)
    assert torch.equal(a.e_clause_lanes, b.e_clause_lanes)
    assert torch.equal(a.e_class_lanes, b.e_class_lanes)
    bk = backends.get_backend("cuda-metered")
    t = (torch.from_numpy(lits), tsys.clause_i, tsys.nonempty, tsys.class_i)
    assert torch.equal(bk.fused_impact(*t, thresh=TH),
                       bk.fused_impact_metered(*t, thresh=TH)[0])


def test_unregister_backend_round_trip():
    class Probe(backends.TorchBackend):
        name = "torch-probe"

    probe = backends.register_backend(Probe())
    try:
        assert backends.get_backend("torch-probe") is probe
        assert "torch-probe" in backends.available_backends()
    finally:
        assert backends.unregister_backend("torch-probe") is probe
    assert "torch-probe" not in backends.available_backends()
    with pytest.raises(ValueError, match="unknown backend"):
        backends.get_backend("torch-probe")
    with pytest.raises(ValueError, match="not registered"):
        backends.unregister_backend("torch-probe")

    class NoPackedMetered(backends.TorchBackend):
        name = "no-packed-metered"
        fused_impact_packed_metered = None

    with pytest.raises(TypeError, match="fused_impact_packed_metered"):
        backends.register_backend(NoPackedMetered())
    assert "no-packed-metered" not in backends.available_backends()

"""The compile-once session on the CPU: one captured CUDA graph per
prepared ``(entry, batch)`` (``repro_torch.impact.graphs``), with the
capture replaced by a recorder.

The CPU cannot capture, so ``graphs.capture`` is monkeypatched with a
recorder that runs the entry's body on the static buffers at capture and
again at every replay, and logs both; ``graphs.enabled`` is patched to
say yes.  Everything around the capture is the session's own: the
static inputs, the copy in, the clone out, ``trace_count``, the launch
counts added per replay, ``refresh_operands`` writing in place, the
audit's ``"graph"`` check.  Results are held bitwise to the eager
session, and the graphed and eager sessions to the JAX session
(``"xla"``) at the reference's tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.impact import IMPACTConfig as JConfig
from repro.impact import RuntimeSpec as JSpec
from repro.impact.pipeline import IMPACTSystem as JSystem
from repro_torch import kernels
from repro_torch.analysis import ir_audit
from repro_torch.convert import system_from_arrays
from repro_torch.impact import RuntimeSpec, build_coresident, graphs
from repro_torch.impact.yflash import read_current
from repro_torch.kernels import _build
from repro_torch.kernels.fused_impact import KERNEL as FUSED

from _torch_graph_recorder import Recorder, patch

# (B, K, n, M, R, tr, C, tc, S, sr): a sharded ragged grid.
LAYOUT = (12, 120, 40, 5, 2, 64, 2, 24, 2, 24)
# Real kernel symbols of fused_impact.cu, as the driver names them.
TILES = ("_ZN48_GLOBAL__N__5b68df1e_15_fused_impact_cu_968572f212impact_"
         "tilesILi16ELb1EEEvPKaPKfPfii")
TAIL = ("_ZN48_GLOBAL__N__5b68df1e_15_fused_impact_cu_968572f211impact_"
        "tailILb0EEEvPKfPKhS2_PfS5_S5")
ATEN = ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_22CUDAFunctor"
        "OnOther_addIfEESt5arrayI")


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
    # Rows that set every included literal of some clauses, so they fire.
    lits = rng.random((B, K)) < 0.5
    inc = include[:K, :n]
    for row in lits:
        for j in rng.choice(n, 3, replace=False):
            row[inc[:, j]] = True
    valid = np.ones(B, bool)
    valid[rng.choice(B, size=B // 4, replace=False)] = False
    return d, lits, valid


@pytest.fixture(scope="module")
def data():
    return _arrays(*LAYOUT)


@pytest.fixture
def system(data):
    return system_from_arrays(data[0], device="cpu")


@pytest.fixture
def graphed(monkeypatch):
    """Sessions compiled while this fixture is active capture through the
    recorder it returns."""
    return _patch(monkeypatch, Recorder())


def _patch(monkeypatch, rec):
    return patch(monkeypatch.setattr, rec)


def _spec(**kw):
    return RuntimeSpec(device="cpu", **kw)


def _eager(rec, system, method, *args, **kw):
    """``method(*args)`` of a new session of ``system`` on ``_spec(**kw)``
    that runs its entries eagerly -> (the session, the result)."""
    from repro_torch.impact.runtime import InferenceSession
    with rec.off():
        sess = InferenceSession(system, _spec(**kw))
        return sess, getattr(sess, method)(*args)


def _eager_call(sess, entry, *args):
    """The entry's eager body on the same operands."""
    return sess.entry_fn(entry)(*(
        torch.as_tensor(x).to(d) for x, (_, d)
        in zip(args, sess.input_specs(entry, args[0].shape[0]))))


@pytest.mark.parametrize("packing", ["none", "2bit"])
@pytest.mark.parametrize("metering", ["off", "staged", "fused"])
def test_calls_copy_in_and_clone_out(data, system, graphed, metering,
                                     packing):
    _, lits, valid = data
    B = len(lits)
    sess = system.compile(_spec(metering=metering, packing=packing,
                                capacity=B))
    assert sess.graphed and sess.graph("infer_step", B) is not None
    assert graphed.log == [("capture", ((B, 120), (B,)))]

    first = sess.infer_step(lits, valid)
    held = [t.clone() for t in (first.predictions, first.e_clause_lanes,
                                first.e_class_lanes)]
    want = _eager_call(sess, "infer_step", lits, valid)
    for got, w in zip(held, want):
        assert torch.equal(got, w)
    assert (first.predictions[torch.as_tensor(~valid)] == -1).all()
    assert (first.predictions >= 0).sum() > 0

    # Call n + 1 on other literals (as a tensor this time) leaves call
    # n's result as it was.
    other = torch.as_tensor(np.roll(lits, 3, axis=0))
    second = sess.infer_step(other, torch.as_tensor(valid))
    for got, w in zip((first.predictions, first.e_clause_lanes,
                       first.e_class_lanes), held):
        assert torch.equal(got, w)
    for got, w in zip((second.predictions, second.e_clause_lanes,
                       second.e_class_lanes),
                      _eager_call(sess, "infer_step", other, valid)):
        assert torch.equal(got, w)
    assert graphed.log.count("replay") == 2

    p = sess.predict(lits)
    w_pred, w_scores = _eager_call(sess, "predict", lits)
    assert torch.equal(p.predictions, w_pred)
    assert torch.equal(p.scores, w_scores)
    if metering != "off":
        rep = sess.infer_with_report(lits, valid)
        _, w_rep = _eager(graphed, system, "infer_with_report", lits, valid,
                          metering=metering, packing=packing)
        assert torch.equal(rep.predictions, w_rep.predictions)
        assert rep.report == w_rep.report


@pytest.mark.parametrize("packing", ["none", "2bit"])
def test_refresh_writes_the_graphs_operands_in_place(data, system, graphed,
                                                     packing):
    _, lits, valid = data
    B = len(lits)
    sess = system.compile(_spec(metering="fused", packing=packing,
                                capacity=B))
    ops = [t for t in (sess._clause_i, *(sess._packed or ()),
                       sess._nonempty, sess._class_i) if t is not None]
    ptrs = [t.data_ptr() for t in ops]
    before = sess.infer_step(lits, valid)
    traces = sess.trace_count

    # A write to the fabric: every include of the first 8 clauses reads
    # as LCS now, so they fire on more rows; the class tile scales.
    ci = system.clause_i.clone()
    ci[..., :8] = torch.where(ci[..., :8] > 1e-7, 1e-9, ci[..., :8])
    system.clause_i = ci
    system.class_i = system.class_i * 1.5
    sess.refresh_operands()
    assert [t.data_ptr() for t in ops] == ptrs
    after = sess.infer_step(lits, valid)
    fresh, want = _eager(graphed, system, "infer_step", lits, valid,
                         metering="fused", packing=packing)
    for f in ("predictions", "e_clause_lanes", "e_class_lanes"):
        assert torch.equal(getattr(after, f), getattr(want, f)), f
    assert not torch.equal(after.e_class_lanes, before.e_class_lanes)
    assert sess.trace_count == traces
    assert graphed.log.count(("capture", ((B, 120), (B,)))) == 1
    if packing == "2bit":
        assert torch.equal(sess._packed.bits, fresh._packed.bits)


def test_refresh_with_new_shapes_recaptures_without_counting(
        data, system, graphed):
    _, lits, valid = data
    B = len(lits)
    sess = system.compile(_spec(metering="staged", capacity=B))
    before = sess.infer_step(lits, valid)
    traces = sess.trace_count
    # A class column of 0 A: the same predictions, a new shape.
    system.class_i = torch.cat([system.class_i, torch.zeros(
        (*system.class_i.shape[:2], 1))], dim=2)
    sess.refresh_operands()
    assert sess.compiled_shapes() == [("infer_step", B)]
    got = sess.infer_step(lits, valid)
    want = _eager_call(sess, "infer_step", lits, valid)
    for g, w in zip((got.predictions, got.e_clause_lanes, got.e_class_lanes),
                    want):
        assert torch.equal(g, w)
    assert torch.equal(got.predictions, before.predictions)
    assert sess.graph("infer_step", B).inputs[0].shape == (B, 120)
    assert sess.trace_count == traces
    assert sum(1 for e in graphed.log if e[0] == "capture") == 2


def test_replays_add_the_recorded_launches(data, system, graphed):
    _, lits, _ = data
    B = len(lits)
    graphed.launches[FUSED] = 1
    sess = system.compile(_spec(metering="off", batch_sizes=(B,)))
    traces = sess.trace_count
    assert sess.graph("predict", B).launches == {"fused_impact_f32": 1}
    before = kernels.launch_counts()["fused_impact_f32"]
    for i in range(100):
        sess.predict(np.roll(lits, i, axis=0))
    assert kernels.launch_counts()["fused_impact_f32"] - before == 100
    assert sess.trace_count == traces
    assert graphed.log.count("replay") == 100


def test_launches_at_capture_are_recorded_not_counted(monkeypatch):
    """``CudaKernel`` counts a launch, or adds it to the innermost
    ``record_launches`` record; ``add_launches`` counts a record once."""
    monkeypatch.setattr(_build, "entry", lambda *a, **k: lambda *x: 0)
    k = FUSED
    n0 = k.launches
    k()
    assert k.launches == n0 + 1
    with _build.record_launches() as rec:
        k()
        k()
    assert k.launches == n0 + 1 and rec == {k: 2}
    assert _build.record_symbols(rec) == {"fused_impact_f32": 2}
    _build.add_launches(rec)
    assert k.launches == n0 + 3


class _FakeStream:
    def __init__(self, device=None):
        pass

    def wait_stream(self, other):
        pass


class _FakeGraph:
    def __init__(self, keep_graph=False):
        self.log = []

    def capture_begin(self, pool=None):
        self.log.append("begin")

    def capture_end(self):
        self.log.append("end")

    def instantiate(self):
        self.log.append("instantiate")


@pytest.mark.parametrize("fails", [False, True])
def test_capture_keeps_the_collector_off(monkeypatch, fails):
    """``graphs.capture`` runs the body's captured pass with the garbage
    collector off (a collection freeing another graph then would
    invalidate the capture on the card), and turns it back on after,
    also when the body raises; the eager pass before it collects as
    usual.  The CUDA stream and graph are fakes on the CPU."""
    import contextlib
    import gc
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(graphs, "census", lambda g: None)
    seen = []

    def body(x):
        seen.append(gc.isenabled())
        if fails and len(seen) == 2:
            raise RuntimeError("body failed")
        return x + 1

    assert gc.isenabled()
    if fails:
        with pytest.raises(RuntimeError, match="body failed"):
            graphs.capture(body, [torch.zeros(2)], None)
    else:
        cap = graphs.capture(body, [torch.zeros(2)], None)
        assert cap.graph.log == ["begin", "end", "instantiate"]
    assert seen == [True, False] and gc.isenabled()


def test_no_graph_at_b0(data, system, graphed):
    _, lits, _ = data
    sess = system.compile(_spec(metering="fused"))
    got = sess.infer_step(lits[:0], np.zeros(0, bool))
    assert got.predictions.shape == (0,) and got.e_clause_lanes.shape == (0,)
    assert sess.predict(lits[:0]).scores.shape == (0, 5)
    assert sess.graph("infer_step", 0) is None
    assert graphed.log == []
    report = sess.audit()
    assert report.ok, report.findings


def test_shape_mismatches_raise(data, system, graphed):
    _, lits, valid = data
    B = len(lits)
    sess = system.compile(_spec(metering="fused", capacity=B))
    with pytest.raises(ValueError, match="valid shape"):
        sess.infer_step(lits, valid[:-1])
    with pytest.raises(ValueError, match="literals must be"):
        sess.infer_step(lits[:, :-1], valid)
    with pytest.raises(ValueError, match="literals must be"):
        sess.predict(lits[0])
    lit2 = np.concatenate([lits, lits])
    masks = np.zeros((2 * B, 40), bool)
    draws = np.zeros((120, 40), np.int32)
    with pytest.raises(ValueError, match="ta_feedback operand"):
        sess.ta_feedback(lit2, masks, masks, masks[:-1], draws, draws,
                         draws.astype(bool))
    assert graphed.log.count("replay") == 0


def test_failed_capture_raises_with_no_eager_retry(data, system,
                                                   monkeypatch):
    _, lits, _ = data
    err = "CUDA error: operation not permitted when stream is capturing"
    _patch(monkeypatch, Recorder(fail=err))
    sess = system.compile(_spec(metering="off"))
    assert sess.graphed
    calls = []
    monkeypatch.setattr(type(sess), "_predict_fn",
                        lambda self, *a: calls.append(a))
    with pytest.raises(RuntimeError, match=r"predict@12 .*not permitted"):
        sess.predict(lits)
    assert calls == [] and not sess.is_compiled("predict", len(lits))
    assert sess.trace_count == 0


def test_graph_findings_on_synthetic_censuses():
    trace = ("aten.zeros.default() -> i8[8]\n"
             "kernel fused_impact_f32(i8[8,120]) -> f32[8,5]\n"
             "aten.argmax.default(f32[8,5]) -> i64[8]\n")

    class G:
        def __init__(self, launches, kernels):
            self.launches = launches
            self.census = graphs.Census(kernels=kernels, other={"memcpy": 1})

    ok = G({"fused_impact_f32": 1}, (TILES, TAIL, ATEN))
    assert ok.census.port_kernels == 2 and ok.census.library_kernels == 1
    assert "impact_tiles<16,1> x1" in ok.census.describe()
    assert ir_audit.graph_findings(ok, trace, 2) == []
    assert ir_audit.traced_launches(trace) == {"fused_impact_f32": 1}

    def kinds(g, port=2, tr=trace):
        return [(f.check, f.severity) for f in
                ir_audit.graph_findings(g, tr, port, entry="predict",
                                        batch=8)]
    assert kinds(None) == [("graph", "error")]
    assert ir_audit.graph_findings(None, trace, 0, batch=0) == []
    assert kinds(G({"fused_impact_f32": 2}, (TILES, TAIL))) == [
        ("graph", "error")]
    assert kinds(G({"fused_impact_f32": 1}, (TILES, TAIL, TILES))) == [
        ("graph", "error")]
    assert kinds(G({}, (ATEN,))) == [("graph", "error")] * 2


def test_audit_holds_each_prepared_entry_to_its_graph(data, system,
                                                      monkeypatch):
    """On a card the audit's ``"graph"`` check reads each prepared entry's
    capture; here the recorder's census holds no kernel of the port, the
    traces one ``fused_impact`` launch, and the record none."""
    B = len(data[1])
    plain = system.compile(_spec(metering="off", batch_sizes=(B,)))
    assert plain.audit().ok            # the CPU: nothing to check
    _patch(monkeypatch, Recorder())
    sess = system.compile(_spec(metering="off", capacity=B))
    report = sess.audit()
    graph = [f for f in report.findings if f.check == "graph"]
    assert not report.ok and len(graph) == 2
    assert {(f.entry, f.batch) for f in graph} == {("infer_step", B)}
    ref = system.compile(_spec(backend="torch", metering="off", capacity=B))
    assert ref.audit().ok              # a reference lowering launches none


def test_coresident_entries_capture_their_model_ids(data, system, graphed):
    _, _, valid = data
    members = [system_from_arrays(_arrays(8, 60, 20, 3, 1, 64, 1, 24, 1,
                                          24, seed=s)[0], device="cpu")
               for s in (2, 3)]
    combined, plan = build_coresident(members)
    B = 8
    rng = np.random.default_rng(4)
    co_lits = rng.random((B, combined.n_literals)) < 0.5
    mids = np.arange(B) % 2
    sess = combined.compile(_spec(coresident=plan, metering="fused",
                                  capacity=B))
    assert graphed.log == [("capture", ((B, 120), (B,), (B,)))]
    got = sess.infer_step(co_lits, valid[:B], model_ids=mids)
    want = _eager_call(sess, "infer_step", co_lits, valid[:B], mids)
    for g, w in zip((got.predictions, got.e_clause_lanes, got.e_class_lanes),
                    want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="model_ids must lie"):
        sess.infer_step(co_lits, valid[:B], model_ids=mids + 1)


@pytest.fixture(scope="module")
def jax_system(data):
    d = data[0]
    return JSystem(
        clause_g=jnp.asarray(d["clause_g"]), nonempty=jnp.asarray(
            d["nonempty"]), class_g=jnp.asarray(d["class_g"]),
        clause_i=jnp.asarray(d["clause_i"]), class_i=jnp.asarray(
            d["class_i"]), n_literals=d["n_literals"],
        n_clauses=d["n_clauses"], n_classes=d["n_classes"], cfg=JConfig(),
        encode_stats=dict(program_energy_j=d["program_energy_j"],
                          erase_energy_j=d["erase_energy_j"]))


@pytest.mark.parametrize("capture", [False, True])
def test_sessions_match_the_jax_session(data, system, jax_system,
                                        monkeypatch, capture):
    """The real CPU session, and the same spec with its entries graphed
    through the recorder, against the reference's ``"xla"`` session."""
    _, lits, valid = data
    if capture:
        _patch(monkeypatch, Recorder())
    sess = system.compile(_spec(metering="fused"))
    js = jax_system.compile(JSpec(backend="xla", metering="fused"))
    w_step = js.infer_step(jnp.asarray(lits), jnp.asarray(valid))
    step = sess.infer_step(lits, valid)
    assert (sess.graph("infer_step", len(lits)) is not None) == capture
    np.testing.assert_array_equal(step.predictions.numpy(),
                                  np.asarray(w_step.predictions))
    np.testing.assert_allclose(step.e_clause_lanes.numpy(),
                               np.asarray(w_step.e_clause_lanes), rtol=1e-3)
    np.testing.assert_allclose(step.e_class_lanes.numpy(),
                               np.asarray(w_step.e_class_lanes), rtol=1e-5)
    w_pred = js.predict(jnp.asarray(lits))
    pred = sess.predict(lits)
    np.testing.assert_array_equal(pred.predictions.numpy(),
                                  np.asarray(w_pred.predictions))
    np.testing.assert_allclose(pred.scores.numpy(),
                               np.asarray(w_pred.scores), rtol=1e-6)

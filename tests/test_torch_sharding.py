"""The port's sharded crossbar (``repro_torch.sharding``,
``repro_torch.launch.mesh``, sessions with a ``Topology``) against the
reference's ``repro.sharding`` and its ``fused_impact_shmap`` lowering.

(a) ``shard_plan`` / ``shardable`` / ``data_axes`` / ``model_size`` equal
the reference's on every mode, plan and error, over a ``FakeMesh``; (b)
the rules tables equal the reference's; (c) two ``gloo`` worlds on the
CPU, of 2 ranks (model 2) and of 4 (2 data x 2 model, and 1 x 4),
started with ``torch.multiprocessing.spawn`` on a file rendezvous
(``tests/_torch_sharding_ranks.py`` is the rank program), run the
reference's ``SHARD_SHAPES`` and ``ASYM_SHAPES`` whose model axis is 2 or
4, a batch that does not divide the data axis, both packings, ``valid``
with free lanes, ``lane_cols``, sessions under ``Topology(mesh, shard)``
with all three meterings, the same sessions at every placement served
through staged graphs (``tests/_torch_graph_recorder.py`` stands in for
the capture: one graph a local stage, the all-reduces between the
replays) against their eager twins, ``IMPACTEngine.run`` on every rank,
and ``replay_trace`` on a ``time.monotonic`` engine (every reading rank
0's); (d) one subprocess runs the reference's lowering and sessions on
8 forced host devices (``JAX_PLATFORMS=cpu``, as
``tests/test_crossbar_sharding.py`` does) and the ranks are held to it.

Tolerances: CSA bits (read through an identity class operand) and
argmax exact; scores rtol 1e-6; lane meters and per-lane energies rtol
1e-5, zero on free lanes; per-request bills sum to the batch meter at
rel 1e-9 (the port bills in f64); every rank of a world returns the same
full result, bit for bit; a graphed sharded session returns its eager
twin's outputs bit for bit.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.sharding import crossbar as jcrossbar
from repro.sharding import rules as jrules
from repro_torch.analysis import ir_audit
from repro_torch.convert import system_from_arrays
from repro_torch.impact import RuntimeSpec, Topology, build_coresident
from repro_torch.impact import graphs
from repro_torch.launch.mesh import (make_crossbar_mesh, make_debug_mesh,
                                     spawn)
from repro_torch.kernels.crossbar_mvm import KERNEL as MVM
from repro_torch.sharding import crossbar, rules

import _torch_sharding_ranks as ranks
from _torch_graph_recorder import Recorder, patch
from test_torch_runtime import _arrays

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
RTOL_SCORES, RTOL_METER = 1e-6, 1e-5


class FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)


# -- (a) placement, over dict-shaped meshes ----------------------------------

MESHES = {"data2-model4": dict(data=2, model=4), "data8": dict(data=8),
          "model1": dict(data=4, model=1), "model2": dict(model=2),
          "pod-data-model": dict(pod=2, data=2, model=2), "none": None}
GRIDS = [(4, 8), (3, 4), (4, 6), (3, 6), (4, 4), (1, 1), (13, 8)]


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("mode", list(jcrossbar.SHARD_MODES) + ["diagonal"])
@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
def test_shard_plan_equals_reference(mesh, mode):
    """Every mode on every mesh shape and grid: the same plan, or the same
    ValueError message."""
    axes = MESHES[mesh]
    m = None if axes is None else FakeMesh(**axes)
    assert crossbar.SHARD_MODES == jcrossbar.SHARD_MODES
    for R, S in GRIDS:
        got = _outcome(crossbar.shard_plan, m, R, S, mode)
        want = _outcome(jcrossbar.shard_plan, m, R, S, mode)
        assert got == want, (R, S)
        if mode == "auto":
            assert crossbar.shardable(m, R, S) == jcrossbar.shardable(m, R,
                                                                      S)


@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
def test_axes_equal_reference(mesh):
    axes = MESHES[mesh]
    m = None if axes is None else FakeMesh(**axes)
    assert crossbar.model_size(m) == jcrossbar.model_size(m)
    assert crossbar.data_axes(m) == jcrossbar.data_axes(m)


# -- (b) the rule tables ------------------------------------------------------

TABLES = [("param_rules", {}), ("param_rules", dict(zero3=True)),
          ("opt_rules", {}), ("act_rules", {}),
          ("act_rules", dict(seq_parallel=False)), ("crossbar_rules", {}),
          ("merged_rules", {}), ("merged_rules", dict(zero3=True)),
          ("merged_rules", dict(seq_parallel=False))]


@pytest.mark.parametrize("axes", [dict(data=2, model=4),
                                  dict(pod=2, data=2, model=2)],
                         ids=["single-pod", "multi-pod"])
@pytest.mark.parametrize("table,kw", TABLES,
                         ids=[f"{t}-{k}" for t, k in TABLES])
def test_rules_equal_reference(table, kw, axes):
    m = FakeMesh(**axes)
    assert getattr(rules, table)(m, **kw) == getattr(jrules, table)(m, **kw)


# -- meshes and sessions without a world --------------------------------------

def test_meshes_need_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_crossbar_mesh(2, device_type="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_debug_mesh(1, 2, device_type="cpu")


def _small_system(mesh=None):
    d, lits, valid = _arrays(8, 120, 40, 5, 2, 64, 2, 24, 2, 24, seed=3)
    system = system_from_arrays(d, device="cpu")
    system.mesh = mesh
    return system, lits


def test_topology_resolution():
    """The session resolves mesh and plan once: the spec's mesh, else the
    system's; ``"none"`` forces one device; an explicit mode without a
    mesh, or an unknown mode, raises; a non-Topology raises TypeError."""
    mesh, other = FakeMesh(data=1, model=2), FakeMesh(data=2, model=2)
    system, _ = _small_system(mesh)
    s = system.compile(RuntimeSpec(device="cpu"))
    assert s.mesh is mesh and s.plan == (True, True)
    s = system.compile(RuntimeSpec(device="cpu",
                                   topology=Topology(mesh=other, shard="r")))
    assert s.mesh is other and s.plan == (True, False)
    assert system.compile(RuntimeSpec(
        device="cpu", topology=Topology(shard="none"))).plan is None
    bare, _ = _small_system()
    assert bare.compile(RuntimeSpec(device="cpu")).plan is None
    with pytest.raises(ValueError, match="neither the spec nor the system"):
        bare.compile(RuntimeSpec(device="cpu",
                                 topology=Topology(shard="both")))
    with pytest.raises(ValueError, match="shard mode"):
        Topology(shard="diagonal")
    with pytest.raises(TypeError, match="Topology"):
        RuntimeSpec(device="cpu", topology=FakeMesh(model=2))
    assert RuntimeSpec().topology == Topology()


def test_sharded_session_prices_its_own_rank(monkeypatch):
    """``route`` is ``"sharded"`` for every serving entry; the work is
    this rank's local shards and lanes; on a card a sharded entry with a
    lane is captured (no eager reason), and only B = 0 runs eagerly,
    which the audit's graph check reports as info."""
    mesh = FakeMesh(data=1, model=2)
    monkeypatch.setattr(mesh, "get_local_rank", lambda axis: 0,
                        raising=False)
    system, _ = _small_system(mesh)
    s = system.compile(RuntimeSpec(device="cpu", metering="fused"))
    one = system.compile(RuntimeSpec(device="cpu", metering="staged",
                                     topology=Topology(shard="none")))
    assert {s.route(e) for e in ("predict", "infer_step",
                                 "infer_with_report")} == {"sharded"}
    assert s.route("ta_feedback") == "ta_feedback"
    # R = 2 and S = 2 over 2 ranks: one clause and one class call a rank.
    assert s.mvm_calls() == [one.mvm_calls()[0], one.mvm_calls()[2]]
    assert s.cost_analysis("predict", 8)["launches"] == sum(
        i.launches for i in s.work_items("predict", 8))
    packed = system.compile(RuntimeSpec(device="cpu", packing="2bit"))
    assert len(packed.mvm_calls()) == 4 + 1      # 4 bitplanes + 1 class
    monkeypatch.setattr(graphs, "enabled", lambda device: True)
    for e in ("predict", "infer_step", "infer_with_report", "ta_feedback"):
        assert s.eager_reason(e, 8) is None
    assert "B = 0" in s.eager_reason("infer_step", 0)
    f = ir_audit.graph_findings(None, "", 0, entry="infer_step", batch=0,
                                reason=s.eager_reason("infer_step", 0))
    assert [(x.check, x.severity) for x in f] == [("graph", "info")]
    assert "B = 0" in f[0].message
    assert ir_audit.AuditReport(tuple(f), {}, {}, 1).ok
    f = ir_audit.graph_findings(None, "", 3, entry="infer_step", batch=8,
                                reason=s.eager_reason("infer_step", 8))
    assert [(x.check, x.severity) for x in f] == [("graph", "error")]


# A kernel node of crossbar_mvm.cu, named as cuFuncGetName gives it.
MVM_NODE = ("_ZN47_GLOBAL__N__5b68df1e_15_crossbar_mvm_cu_968572f29mvm_"
            "tilesILi1ELi1EEEvPKfS2_Pfiiifff")


@pytest.mark.parametrize("packing", ["none", "2bit"])
def test_sharded_entry_captures_one_graph_a_stage(monkeypatch, packing):
    """On a card (the recorder stands in for the capture) a sharded
    serving entry is a ``StagedEntry``: the clause stage, the class stage
    and the finish, each captured once into the session's pool, the
    second and third reading the static outputs of the one before; the
    priced launches split over the stages; the audit holds each stage's
    census to its share, and a census that lost a node is an error."""
    mesh = FakeMesh(data=1, model=2)
    monkeypatch.setattr(mesh, "get_local_rank", lambda axis: 0,
                        raising=False)
    system, _ = _small_system(mesh)
    rec = patch(monkeypatch.setattr, Recorder())
    s = system.compile(RuntimeSpec(device="cpu", metering="fused",
                                   packing=packing, capacity=8))
    g = s.graph("infer_step", 8)
    assert isinstance(g, graphs.StagedEntry) and s.trace_count == 1
    assert [x for x in rec.log if x[0] == "capture"] == [
        ("capture", ((8, 120), (8,))),
        ("capture", ((8, 120), (8,), (8, 48), (8, 1, 48))),
        ("capture", ((8, 120), (8,), (8, 7)))]
    viol, i_col = g.stages[0][0].outputs
    assert all(x is y for x, y in zip(g.stages[1][0].graph.inputs[2:],
                                      (viol, i_col)))
    assert g.stages[2][1] is None
    per = s.stage_launches("infer_step", 8)
    cost = s.cost_analysis("infer_step", 8)["launches"]
    assert len(per) == 3 and sum(per) == cost and per[2] == 0
    # This rank's one class shard makes the class stage's one call; the
    # clause stage makes the rest (one a bitplane when packed).
    calls = [len(s.mvm_calls()) - 1, 1, 0]
    assert calls[0] == (4 if packing == "2bit" else 1)
    for (cap, _), n, c in zip(g.stages, per, calls):
        assert bool(n) == bool(c)
        cap.launches.clear()
        if c:
            cap.launches[MVM] = c
        cap.census = graphs.Census(kernels=(MVM_NODE,) * n, other={})
    # The entry's op trace names one primitive line a wrapper call (its
    # body runs the all-reduces, which a FakeMesh cannot).
    trace = "kernel crossbar_mvm_f32(f32[8,64], f32[64,48])\n" * sum(calls)
    assert g.launches == ir_audit.traced_launches(trace)
    assert ir_audit.graph_findings(g, trace, per, entry="infer_step",
                                   batch=8) == []
    g.stages[1][0].census = graphs.Census(kernels=(MVM_NODE,) * (per[1] - 1),
                                          other={})
    f = ir_audit.graph_findings(g, trace, per, entry="infer_step", batch=8)
    assert {x.severity for x in f} == {"error"}
    assert any("stage 1 holds" in x.message for x in f)


def test_coresident_grids_never_shard():
    """Co-resident members are single-tile: on a model axis of 2, "auto"
    finds no plan and an explicit placement raises."""
    members = [system_from_arrays(_arrays(4, 24, 8, 3, 1, 24, 1, 8, 1, 8,
                                          seed=i)[0], device="cpu")
               for i in range(2)]
    mesh = FakeMesh(data=1, model=2)
    members[0].mesh = mesh
    combined, plan = build_coresident(members)
    assert combined.mesh is mesh
    s = combined.compile(RuntimeSpec(device="cpu", coresident=plan))
    assert s.plan is None
    with pytest.raises(ValueError, match="divide the model axis"):
        combined.compile(RuntimeSpec(device="cpu", coresident=plan,
                                     topology=Topology(shard="both")))


# -- (c), (d) the gloo worlds against the reference's lowering --------------

SHAPES = {
    "s0": (16, 300, 120, 7, 4, 80, 3, 40, 4, 30),     # SHARD_SHAPES[0], [1]
    "s2": (8, 520, 500, 10, 4, 130, 2, 256, 2, 250),  # SHARD_SHAPES[2]
    "a0": (8, 300, 120, 7, 4, 80, 3, 40, 3, 40),      # ASYM_SHAPES: R-only
    "a1": (8, 300, 126, 7, 3, 100, 3, 42, 4, 32),     # S-only
    "a2": (16, 512, 96, 5, 8, 64, 2, 48, 3, 32),      # R-only, model 4
    "b5": (5, 300, 120, 7, 4, 80, 3, 40, 4, 30),      # B does not divide
}
# The reference's lowering runs once a case of inputs and model axis:
# name -> (inputs, (n_data, n_model)).  Its result does not depend on the
# data axis, so each world-4 case on a 2 x 2 mesh is held to the 1 x 2
# run (the batch of 5 runs on 2 x 2, where it replicates).
REF_CASES = {"s0-m2": ("s0", (1, 2)), "s0-m4": ("s0", (1, 4)),
             "s2-m2": ("s2", (1, 2)), "a0-m2": ("a0", (1, 2)),
             "a1-m2": ("a1", (1, 2)), "a2-m4": ("a2", (1, 4)),
             "b5-m2": ("b5", (2, 2))}
# (name, inputs, world, (n_data, n_model), plan, reference case)
CASES = [("w2-s0", "s0", 2, (1, 2), (True, True), "s0-m2"),
         ("w2-s2", "s2", 2, (1, 2), (True, True), "s2-m2"),
         ("w2-a0", "a0", 2, (1, 2), (True, False), "a0-m2"),
         ("w2-a1", "a1", 2, (1, 2), (False, True), "a1-m2"),
         ("w4-s0", "s0", 4, (2, 2), (True, True), "s0-m2"),
         ("w4-s0-m4", "s0", 4, (1, 4), (True, True), "s0-m4"),
         ("w4-s2", "s2", 4, (2, 2), (True, True), "s2-m2"),
         ("w4-a0", "a0", 4, (2, 2), (True, False), "a0-m2"),
         ("w4-a1", "a1", 4, (2, 2), (False, True), "a1-m2"),
         ("w4-a2", "a2", 4, (1, 4), (True, False), "a2-m4"),
         ("w4-b5", "b5", 4, (2, 2), (True, True), "b5-m2")]
WORLDS = (2, 4)
SESSION_INPUTS = "s0"
# The sessions the reference also compiles (each entry an AOT compile).
REF_SESSIONS = (("none", "off"), ("none", "staged"), ("none", "fused"),
                ("2bit", "fused"))
N_REQUESTS = 24

REFERENCE = textwrap.dedent("""
    import functools, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.impact import IMPACTConfig, RuntimeSpec, Topology
    from repro.impact.pipeline import IMPACTSystem
    from repro.impact.yflash import I_CSA_THRESHOLD as TH
    from repro.kernels import packing, ref
    from repro.sharding import crossbar

    tmp = sys.argv[1]
    spec = json.load(open(os.path.join(tmp, "cases.json")))
    z = np.load(os.path.join(tmp, "inputs.npz"))
    devs = np.array(jax.devices())
    out = {}

    def mesh_of(n_data, n_model):
        return Mesh(devs[:n_data * n_model].reshape(n_data, n_model),
                    ("data", "model"))

    def eye(S, sr, n):
        e = np.zeros((S * sr, n), np.float32)
        k = min(S * sr, n)
        e[np.arange(k), np.arange(k)] = 1.0
        return jnp.asarray(e.reshape(S, sr, n))

    for name, (key, mesh_shape) in spec["refs"].items():
        g = lambda f: jnp.asarray(z[key + "/" + f])
        lit, ci, ne, cls = g("lits"), g("clause_i"), g("nonempty"), g("class_i")
        valid, lc = g("valid"), g("lane_cols")
        R, C, tr, tc = ci.shape
        S, sr, _ = cls.shape
        mesh = mesh_of(*mesh_shape)
        plan = crossbar.shard_plan(mesh, R, S)
        out[name + "/plan"] = np.array(plan)
        sh = functools.partial(crossbar.fused_impact_shmap, thresh=TH,
                               mesh=mesh, impl="xla", shard_r=plan[0],
                               shard_s=plan[1])

        # One jit a case: eager shard_map dispatches op by op (seconds a
        # call), and each jit compiles for a fraction of a second.
        @jax.jit
        def case(lit, ci, ne, cls, valid, lc, eye_cls):
            pk = packing.pack_clause_operand(ci)
            res = dict(scores=sh(lit, ci, ne, cls),
                       bits=sh(lit, ci, ne, eye_cls),
                       bits_oracle=ref.fused_impact_ref(lit, ci, ne, eye_cls,
                                                        thresh=TH))
            for what, kw in (
                    ("metered", dict(valid=valid)),
                    ("lanes", dict(valid=valid, lane_cols=lc)),
                    ("packed_valid", dict(valid=valid, packed=pk,
                                          packed_tr=tr)),
                    ("packed", dict(packed=pk, packed_tr=tr))):
                args = (lit, None if "packed" in kw else ci, ne, cls)
                for i, r in enumerate(sh(*args, meter=True, **kw)):
                    res[what + "/" + str(i)] = r
            return res

        for k, v in case(lit, ci, ne, cls, valid, lc,
                         eye(S, sr, C * tc)).items():
            out[name + "/" + k] = v

    key = spec["system"]
    system = IMPACTSystem(
        clause_g=jnp.asarray(z[key + "/clause_g"]),
        nonempty=jnp.asarray(z[key + "/nonempty"]),
        class_g=jnp.asarray(z[key + "/class_g"]),
        clause_i=jnp.asarray(z[key + "/clause_i"]),
        class_i=jnp.asarray(z[key + "/class_i"]),
        n_literals=int(z[key + "/n_literals"]),
        n_clauses=int(z[key + "/n_clauses"]),
        n_classes=int(z[key + "/n_classes"]), cfg=IMPACTConfig(),
        encode_stats=dict(program_energy_j=1.5e-3, erase_energy_j=2.5e-9))
    lits = jnp.asarray(z[key + "/lits"])
    buf, valid = jnp.asarray(z["session/buf"]), jnp.asarray(z["session/valid"])
    for pk, m in spec["sessions"]:
        s = system.compile(RuntimeSpec(
            backend="xla", metering=m, packing=pk, capacity=len(buf),
            topology=Topology(mesh=mesh_of(1, 2))))
        k = "sess/%s/%s/" % (pk, m)
        p = s.predict(lits)
        out[k + "pred"], out[k + "scores"] = p.predictions, p.scores
        r = s.infer_step(buf, valid)
        out[k + "step_pred"] = r.predictions
        out[k + "e_cl"], out[k + "e_cs"] = (r.e_clause_lanes,
                                            r.e_class_lanes)
        if m != "off":
            rep = s.infer_with_report(buf, valid=valid).report
            out[k + "report"] = np.array(
                [rep.read_energy_j, rep.clause_energy_j,
                 rep.class_energy_j, rep.datapoints, rep.ops_crosspoint])
    np.savez(os.path.join(tmp, "ref.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    print("REF_OK", jax.device_count())
""")


def _inputs(tmp: pathlib.Path) -> None:
    """The cases and their numpy inputs, for the reference and the ranks."""
    arrays = {}
    for key, shape in SHAPES.items():
        d, lits, valid = _arrays(*shape, seed=len(key) + shape[0])
        rng = np.random.default_rng(shape[0] + shape[1])
        n = d["clause_i"].shape[1] * d["clause_i"].shape[3]
        arrays.update({f"{key}/{f}": np.asarray(v) for f, v in d.items()
                       if f not in ("program_energy_j", "erase_energy_j")})
        arrays[f"{key}/lits"] = lits
        arrays[f"{key}/valid"] = valid
        arrays[f"{key}/lane_cols"] = rng.random((shape[0], n)) < 0.7
    lits = arrays[f"{SESSION_INPUTS}/lits"]
    valid = arrays[f"{SESSION_INPUTS}/valid"]
    arrays["session/buf"] = np.where(valid[:, None], lits, 1).astype(np.int8)
    arrays["session/valid"] = valid
    rng = np.random.default_rng(99)
    arrays["session/requests"] = (
        rng.random((N_REQUESTS, lits.shape[1])) < 0.5).astype(np.int8)
    arrays["session/replay"] = (
        rng.random((ranks.REPLAY_REQUESTS, lits.shape[1])) < 0.5).astype(
            np.int8)
    np.savez(tmp / "inputs.npz", **arrays)
    cases = [dict(name=n, inputs=i, world=w, mesh=list(m))
             for n, i, w, m, _, _ in CASES]
    (tmp / "cases.json").write_text(json.dumps(
        dict(cases=cases, refs=REF_CASES, sessions=REF_SESSIONS,
             system=SESSION_INPUTS)))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Run the reference subprocess and the two gloo worlds (at the same
    time) and load what they wrote: {"ref": ..., (world, rank): ...}."""
    tmp = tmp_path_factory.mktemp("sharding")
    _inputs(tmp)
    # JAX_PLATFORMS=cpu matters: see tests/test_crossbar_sharding.py.
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp)],
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             "HOME": os.path.expanduser("~"),
             "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for world in WORLDS:
            spawn(ranks.world_main, world, str(tmp),
                  init_method=f"file://{tmp}/store{world}")
        out, err = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert "REF_OK 8" in out, (out[-2000:], err[-3000:])
    res = {"ref": dict(np.load(tmp / "ref.npz"))}
    for world in WORLDS:
        for r in range(world):
            res[(world, r)] = dict(np.load(tmp / f"w{world}_rank{r}.npz"))
    return res


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0.0)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_result(worlds, world):
    base = worlds[(world, 0)]
    for r in range(1, world):
        mine = worlds[(world, r)]
        assert mine.keys() == base.keys()
        for k in base:
            np.testing.assert_array_equal(mine[k], base[k], err_msg=k)


CASE_IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("name,inputs,world,mesh,plan,ref", CASES,
                         ids=CASE_IDS)
def test_lowering_matches_reference(worlds, name, inputs, world, mesh,
                                    plan, ref):
    """Scores at rtol 1e-6 with argmax exact, against the reference's
    lowering and the port's own single-device kernel; the plan the
    reference's."""
    got, want = worlds[(world, 0)], worlds["ref"]
    assert tuple(got[f"{name}/plan"]) == plan
    assert tuple(want[f"{ref}/plan"]) == plan
    for other in (want[f"{ref}/scores"], got[f"{name}/single"]):
        _close(got[f"{name}/scores"], other, RTOL_SCORES)
        np.testing.assert_array_equal(got[f"{name}/scores"].argmax(-1),
                                      other.argmax(-1))


@pytest.mark.parametrize("name,inputs,world,mesh,plan,ref", CASES,
                         ids=CASE_IDS)
def test_csa_bits_exact(worlds, name, inputs, world, mesh, plan, ref):
    """The fired bits, read through an identity class operand: exactly
    the reference lowering's and its single-device oracle's."""
    got, want = worlds[(world, 0)], worlds["ref"]
    bits = got[f"{name}/bits"]
    np.testing.assert_array_equal(bits, want[f"{ref}/bits"])
    np.testing.assert_array_equal(bits, want[f"{ref}/bits_oracle"])
    assert set(np.unique(bits)) <= {0.0, 1.0} and bits.any()


@pytest.mark.parametrize("what", ["metered", "lanes", "packed",
                                  "packed_valid"])
@pytest.mark.parametrize("name,inputs,world,mesh,plan,ref", CASES,
                         ids=CASE_IDS)
def test_meters_match_reference(worlds, name, inputs, world, mesh, plan,
                                ref, what):
    """Metered lowering with free lanes (``valid``), with a co-residency
    lane mask, and on the 2-bit packed operand: scores rtol 1e-6, lane
    meters rtol 1e-5, and zero on free lanes."""
    got, want = worlds[(world, 0)], worlds["ref"]
    _close(got[f"{name}/{what}/0"], want[f"{ref}/{what}/0"], RTOL_SCORES)
    np.testing.assert_array_equal(got[f"{name}/{what}/0"].argmax(-1),
                                  want[f"{ref}/{what}/0"].argmax(-1))
    for i in (1, 2):
        # atol 0: a free lane's zero meter must be exactly zero here too.
        _close(got[f"{name}/{what}/{i}"], want[f"{ref}/{what}/{i}"],
               RTOL_METER)
    if what != "packed":
        meter = got[f"{name}/{what}/1"]
        assert (meter == 0).any() and (meter > 0).any()


SESSIONS = [(w, pk, m) for w in WORLDS for pk in ranks.PACKINGS
            for m in ranks.METERINGS]


@pytest.mark.parametrize("world,pk,m", SESSIONS,
                         ids=[f"w{w}-{p}-{m}" for w, p, m in SESSIONS])
def test_sessions_match_one_device_and_reference(worlds, world, pk, m):
    """A session under ``Topology(mesh)``: ``predict``, ``infer_step``
    with free lanes and ``infer_with_report`` equal the port's
    single-device session and, where the reference compiled it
    (``REF_SESSIONS``), the reference's sharded session: argmax exact,
    scores rtol 1e-6, energies and reports rtol 1e-5, free lanes -1 and
    billed exactly 0."""
    got, ref = worlds[(world, 0)], worlds["ref"]
    k = f"sess/{pk}/{m}"
    wants = [(got, f"{k}/one")]
    if (pk, m) in REF_SESSIONS:
        wants.append((ref, k))
    mine = f"{k}/mesh"
    for want, w in wants:
        np.testing.assert_array_equal(got[f"{mine}/pred"], want[f"{w}/pred"])
        _close(got[f"{mine}/scores"], want[f"{w}/scores"], RTOL_SCORES)
        np.testing.assert_array_equal(got[f"{mine}/step_pred"],
                                      want[f"{w}/step_pred"])
        for e in ("e_cl", "e_cs"):
            _close(got[f"{mine}/{e}"], want[f"{w}/{e}"], RTOL_METER)
        if m != "off":
            _close(got[f"{mine}/report"], want[f"{w}/report"], RTOL_METER)
    free = got[f"{mine}/step_pred"] == -1
    assert free.any() and not free.all()
    if m != "off":
        assert (got[f"{mine}/e_cl"][free] == 0).all()
        assert (got[f"{mine}/e_cl"][~free] > 0).all()


@pytest.mark.parametrize("world,pk,m", SESSIONS,
                         ids=[f"w{w}-{p}-{m}" for w, p, m in SESSIONS])
def test_sessions_route_price_and_audit(worlds, world, pk, m):
    """Every serving entry routes to the sharded lowering; each entry was
    prepared once; the rank's ``crossbar_mvm`` calls are the calls its
    ``cost_analysis`` prices; the audit passes and the op trace holds the
    all_reduce calls."""
    got = worlds[(world, 0)]
    k = f"sess/{pk}/{m}"
    assert tuple(got[f"{k}/plan"]) == (True, True)
    assert str(got[f"{k}/route"]) == "sharded"
    assert int(got[f"{k}/traces"]) == (3 if m != "off" else 2)
    assert int(got[f"{k}/wrapper_calls"]) == int(got[f"{k}/priced_calls"])
    assert int(got[f"{k}/launches"]) >= int(got[f"{k}/priced_calls"]) > 0
    assert bool(got[f"{k}/audit_ok"])
    assert int(got[f"{k}/allreduce_lines"]) >= 1


@pytest.mark.parametrize("shard,plan", [("both", "(True, True)"),
                                        ("r", "(True, False)"),
                                        ("s", "(False, True)"),
                                        ("none", "none")])
@pytest.mark.parametrize("world", WORLDS)
def test_forced_placements_bill_like_one_device(worlds, world, shard, plan):
    """``Topology(mesh, shard=...)`` pins each placement; fused metering
    then bills as the single-device staged oracle (rtol 1e-5), a
    replicated operand billed once."""
    got = worlds[(world, 0)]
    assert str(got[f"mode/{shard}/plan"]) == plan
    one = "sess/none/staged/one"
    np.testing.assert_array_equal(got[f"mode/{shard}/pred"],
                                  got[f"{one}/step_pred"])
    _close(got[f"mode/{shard}/e_cl"], got[f"{one}/e_cl"], RTOL_METER)
    _close(got[f"mode/{shard}/e_cs"], got[f"{one}/e_cs"], RTOL_METER)


@pytest.mark.parametrize("world", WORLDS)
def test_engine_on_a_sharded_session_bills_exactly(worlds, world):
    """``IMPACTEngine.run`` on every rank: predictions equal the
    single-device session's, every request is billed, and the bills sum
    to the batch meter (rel 1e-9, f64); serving prepared nothing new."""
    got = worlds[(world, 0)]
    d, _, _ = _arrays(*SHAPES[SESSION_INPUTS],
                      seed=len(SESSION_INPUTS) + SHAPES[SESSION_INPUTS][0])
    system = system_from_arrays(d, device="cpu")
    rng = np.random.default_rng(99)
    requests = (rng.random((N_REQUESTS, d["n_literals"])) < 0.5).astype(
        np.int8)
    direct = system.compile(RuntimeSpec(device="cpu")).predict(requests)
    np.testing.assert_array_equal(got["engine/pred"],
                                  direct.predictions.numpy())
    bills = got["engine/bills"]
    assert len(bills) == N_REQUESTS and (bills > 0).all()
    meter = float(got["engine/meter"])
    assert abs(sum(bills.tolist()) - meter) <= 1e-9 * abs(meter)
    assert int(got["engine/traces"]) == 1


def test_crossbar_scaling_reduced(capsys):
    """``python -m repro_torch.crossbar_scaling`` at a reduced size (128
    samples, 1 epoch), with the sharded leg on a world of 2: the clause
    bits are identical across the four tilings, and every prediction on
    every rank equals the single-device run's but for ties to f32
    rounding."""
    from repro_torch import crossbar_scaling
    assert crossbar_scaling.main(["--device", "cpu", "--world-size", "2",
                                  "--samples", "128", "--epochs", "1"]) == 0
    out = capsys.readouterr().out
    assert out.count(" same ") == len(crossbar_scaling.TILINGS)
    assert out.count("rank ") == 2 * len(crossbar_scaling.TILINGS)
    assert "plan (True, True)" in out and "0 other differences" in out


GRAPHED = [(w, sh, pk, m) for w in WORLDS for sh in ranks.PLACEMENTS
           for pk in ranks.PACKINGS for m in ranks.METERINGS]


@pytest.mark.parametrize("world,shard,pk,m", GRAPHED,
                         ids=[f"w{w}-{sh}-{p}-{m}" for w, sh, p, m in GRAPHED])
def test_graphed_sharded_sessions_equal_eager(worlds, world, shard, pk, m):
    """Every placement x packing x metering served through staged graphs
    (the recorder captures on the CPU; the all-reduces run between the
    replays) on every rank: each prepared entry is three captured stages,
    its outputs over two rounds of calls are its eager twin's bit for
    bit, and serving prepares nothing."""
    n_entries = 3 if m != "off" else 2
    for r in range(world):
        got = worlds[(world, r)]
        k = f"graph/{shard}/{pk}/{m}"
        assert bool(got[f"{k}/staged"])
        assert got[f"{k}/stages"].tolist() == [3] * n_entries
        assert int(got[f"{k}/captures"]) == 3 * n_entries
        assert got[f"{k}/traces"].tolist() == [n_entries] * 2
        outs = 5 + (m != "off")
        for i in range(2):
            for j in range(outs):
                np.testing.assert_array_equal(
                    got[f"{k}/{i}/{j}/graphed"], got[f"{k}/{i}/{j}/eager"],
                    err_msg=f"rank {r} call {i} output {j}")
        assert (got[f"{k}/0/2/graphed"] == -1).any()


@pytest.mark.parametrize("world", WORLDS)
def test_replay_trace_on_a_mesh(worlds, world):
    """``replay_trace`` on a ``time.monotonic`` engine over a sharded
    session, every rank reading rank 0's clock: every rank completes,
    sheds, predicts and bills the same; the predictions are one device's;
    the bills sum to the batch meter in f64 (rel 1e-9); serving prepared
    nothing new."""
    base = worlds[(world, 0)]
    for r in range(world):
        got = worlds[(world, r)]
        for k in ("counts", "times", "pred", "bills", "meter"):
            np.testing.assert_array_equal(got[f"replay/{k}"],
                                          base[f"replay/{k}"], err_msg=k)
    n = ranks.REPLAY_REQUESTS
    assert base["replay/counts"].tolist() == [n, n, 0, n]
    d, _, _ = _arrays(*SHAPES[SESSION_INPUTS],
                      seed=len(SESSION_INPUTS) + SHAPES[SESSION_INPUTS][0])
    rng = np.random.default_rng(99)
    rng.random((N_REQUESTS, d["n_literals"]))
    requests = (rng.random((n, d["n_literals"])) < 0.5).astype(np.int8)
    direct = system_from_arrays(d, device="cpu").compile(
        RuntimeSpec(device="cpu")).predict(requests)
    np.testing.assert_array_equal(base["replay/pred"],
                                  direct.predictions.numpy())
    bills, meter = base["replay/bills"], float(base["replay/meter"])
    assert (bills > 0).all()
    assert abs(sum(bills.tolist()) - meter) <= 1e-9 * abs(meter)
    assert int(base["replay/traces"]) == 1
    # replay_zoo_trace on a one-tenant zoo over the same session.
    for r in range(world):
        got = worlds[(world, r)]
        for k in ("counts", "pred", "bills"):
            np.testing.assert_array_equal(got[f"zoo_replay/{k}"],
                                          base[f"zoo_replay/{k}"])
    assert base["zoo_replay/counts"].tolist() == [n, 0]
    np.testing.assert_array_equal(base["zoo_replay/pred"],
                                  base["replay/pred"])


def test_replay_on_a_mesh_refuses_an_injected_clock(monkeypatch):
    """On a mesh of more than one rank, ``replay_trace`` and
    ``replay_zoo_trace`` need a wall clock that rank 0 reads for every
    rank: a per-rank injected clock raises before anything is served, and
    the engine keeps its clock."""
    from repro_torch.serve import IMPACTEngine
    from repro_torch.serve.impact_engine import replay_trace
    from repro_torch.serve.zoo import ModelZoo, SLOClass, replay_zoo_trace
    mesh = FakeMesh(data=1, model=2)
    monkeypatch.setattr(mesh, "get_local_rank", lambda axis: 0,
                        raising=False)
    system, lits = _small_system(mesh)
    session = system.compile(RuntimeSpec(device="cpu", capacity=4))
    clock = ranks.VirtualClock()
    eng = IMPACTEngine(session, clock=clock)
    with pytest.raises(ValueError, match="needs a wall clock"):
        replay_trace(eng, lits, np.zeros(len(lits)))
    assert eng.clock is clock and eng.request_records == []
    zoo = ModelZoo(session, [("t", SLOClass())], clock=clock)
    with pytest.raises(ValueError, match="needs a wall clock"):
        replay_zoo_trace(zoo, [("t", row) for row in lits], np.zeros(2))
    assert zoo.clock is clock and zoo.request_records == []

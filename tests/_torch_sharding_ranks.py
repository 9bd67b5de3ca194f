"""The rank program of ``tests/test_torch_sharding.py``.

``world_main(rank, tmp)`` runs on every rank of a ``gloo`` world that
``repro_torch.launch.mesh.spawn`` starts on the CPU.  It reads the cases
(``cases.json``) and their numpy inputs (``inputs.npz``) from ``tmp``,
drives the port's sharded lowering, sharded sessions (eager, and
graphed through the capture recorder of ``tests/_torch_graph_recorder.py``:
one graph a local stage, the collectives between the replays), an
engine on a sharded session and ``replay_trace`` on a wall clock, and
writes everything it computed to
``w<world>_rank<rank>.npz``; the test holds those outputs against the
reference's ``fused_impact_shmap``, against the port's single-device
sessions (also computed here, on the same rank) and against each other.
This module imports neither JAX nor the reference package, so a rank
starts with the port alone.
"""
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.convert import system_from_arrays
from repro_torch.impact import RuntimeSpec, Topology, graphs
from repro_torch.impact.runtime import InferenceSession
from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
from repro_torch.kernels import _build, ops, packing
from repro_torch.launch.mesh import axis_sizes, make_crossbar_mesh
from repro_torch.serve import IMPACTEngine
from repro_torch.serve.impact_engine import poisson_arrivals, replay_trace
from repro_torch.serve.zoo import ModelZoo, SLOClass, replay_zoo_trace
from repro_torch.sharding import crossbar

from _torch_graph_recorder import Recorder, patch

PACKINGS = ("none", "2bit")
METERINGS = ("off", "staged", "fused")
SHARD_MODES = ("both", "r", "s", "none")
PLACEMENTS = ("both", "r", "s")
ENGINE_CAPACITY = 8
# replay_trace: this many requests of a seeded Poisson trace at this rate.
REPLAY_REQUESTS, REPLAY_RATE = 64, 400.0


class VirtualClock:
    """Reads the same on every rank: each reading advances 0.5 ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 5e-4
        return self.t


def identity_class(S: int, sr: int, n: int) -> torch.Tensor:
    """A class operand (S, sr, n) whose column j reads clause row j with
    a unit current: the class stage then returns the fired bits as its
    scores, exactly (0 and 1 sums)."""
    eye = torch.zeros((S * sr, n), dtype=torch.float32)
    k = min(S * sr, n)
    eye[torch.arange(k), torch.arange(k)] = 1.0
    return eye.reshape(S, sr, n)


def _system_arrays(z, key: str) -> dict:
    d = {f: z[f"{key}/{f}"] for f in ("clause_g", "class_g", "clause_i",
                                       "class_i", "nonempty")}
    d.update({f: int(z[f"{key}/{f}"]) for f in ("n_literals", "n_clauses",
                                                  "n_classes")})
    d.update(program_energy_j=1.5e-3, erase_energy_j=2.5e-9)
    return d


def lowering_case(z, case: dict, mesh, out: dict) -> None:
    """The lowering on one case's inputs: scores, CSA bits (through the
    identity class operand), metered with free lanes, packed metered and
    with a co-residency lane mask."""
    key, name = case["inputs"], case["name"]
    t = lambda f: torch.from_numpy(z[f"{key}/{f}"])
    lit, ci, ne, cls = t("lits"), t("clause_i"), t("nonempty"), t("class_i")
    valid, lane_cols = t("valid"), t("lane_cols")
    R, C, tr, tc = ci.shape
    S, sr, _ = cls.shape
    plan = crossbar.shard_plan(mesh, R, S)
    out[f"{name}/plan"] = np.array(plan)
    out[f"{name}/scores"] = ops.fused_impact(lit, ci, ne, cls, thresh=TH,
                                             mesh=mesh).numpy()
    out[f"{name}/single"] = ops.fused_impact(lit, ci, ne, cls,
                                             thresh=TH).numpy()
    out[f"{name}/bits"] = ops.fused_impact(
        lit, ci, ne, identity_class(S, sr, C * tc), thresh=TH,
        mesh=mesh).numpy()
    kw = dict(thresh=TH, mesh=mesh, shard_r=plan[0], shard_s=plan[1],
              valid=valid, meter=True)
    for what, extra in (("metered", {}),
                        ("lanes", dict(lane_cols=lane_cols))):
        res = crossbar.fused_impact_sharded(lit, ci, ne, cls, **kw, **extra)
        for i, r in enumerate(res):
            out[f"{name}/{what}/{i}"] = r.numpy()
    res = ops.fused_impact_packed(lit, packing.pack_clause_operand(ci), ne,
                                  cls, thresh=TH, tr=tr, mesh=mesh,
                                  meter=True)
    for i, r in enumerate(res):
        out[f"{name}/packed/{i}"] = r.numpy()
    res = crossbar.fused_impact_sharded(
        lit, None, ne, cls, packed=packing.pack_clause_operand(ci),
        packed_tr=tr, **kw)
    for i, r in enumerate(res):
        out[f"{name}/packed_valid/{i}"] = r.numpy()


def _wrapper_calls(fn, *args) -> int:
    """``crossbar_mvm`` wrapper calls made by ``fn(*args)``."""
    calls = []

    def hook(symbol, f, a, k):
        calls.append(symbol)
        return f(*a, **k)

    with _build.launch_hook(hook):
        fn(*args)
    return calls.count("crossbar_mvm_f32")


def session_cases(system, lits, buf, valid, mesh, out: dict) -> None:
    """Every packing x metering on the mesh and on one device: predict,
    infer_step and infer_with_report; on the mesh also the plan, the
    route, the trace count, the launches priced against the wrapper calls
    made, the audit and the all_reduce lines of the op trace."""
    B = lits.shape[0]
    for pk in PACKINGS:
        for m in METERINGS:
            spec = RuntimeSpec(device="cpu", metering=m, packing=pk,
                               capacity=B)
            key = f"sess/{pk}/{m}"
            for tag, s in (("one", system.compile(spec)),
                           ("mesh", system.compile(dataclasses.replace(
                               spec, topology=Topology(mesh=mesh))))):
                p = s.predict(lits)
                out[f"{key}/{tag}/pred"] = p.predictions.numpy()
                out[f"{key}/{tag}/scores"] = p.scores.numpy()
                r = s.infer_step(buf, valid)
                out[f"{key}/{tag}/step_pred"] = r.predictions.numpy()
                out[f"{key}/{tag}/e_cl"] = r.e_clause_lanes.numpy()
                out[f"{key}/{tag}/e_cs"] = r.e_class_lanes.numpy()
                if m != "off":
                    rep = s.infer_with_report(buf, valid).report
                    out[f"{key}/{tag}/report"] = np.array(
                        [rep.read_energy_j, rep.clause_energy_j,
                         rep.class_energy_j, rep.datapoints,
                         rep.ops_crosspoint])
            out[f"{key}/plan"] = np.array(s.plan)
            out[f"{key}/route"] = np.array(s.route("infer_step"))
            out[f"{key}/traces"] = np.array(s.trace_count)
            priced = [i for i in s.work_items("infer_step", B)
                      if i.kernel == "crossbar_mvm_f32"]
            out[f"{key}/priced_calls"] = np.array(len(priced))
            out[f"{key}/launches"] = np.array(
                s.cost_analysis("infer_step", B)["launches"])
            out[f"{key}/wrapper_calls"] = np.array(_wrapper_calls(
                s.infer_step, buf, valid))
            out[f"{key}/audit_ok"] = np.array(s.audit().ok)
            out[f"{key}/allreduce_lines"] = np.array(
                s.ir_text("infer_step", B).count("allreduce"))


def shard_mode_cases(system, buf, valid, mesh, out: dict) -> None:
    """``Topology(mesh, shard=...)`` forcing each placement, fused
    metering."""
    B = buf.shape[0]
    for shard in SHARD_MODES:
        s = system.compile(RuntimeSpec(
            device="cpu", metering="fused", capacity=B,
            topology=Topology(mesh=mesh, shard=shard)))
        r = s.infer_step(buf, valid)
        out[f"mode/{shard}/plan"] = np.array(
            "none" if s.plan is None else str(s.plan))
        out[f"mode/{shard}/pred"] = r.predictions.numpy()
        out[f"mode/{shard}/e_cl"] = r.e_clause_lanes.numpy()
        out[f"mode/{shard}/e_cs"] = r.e_class_lanes.numpy()


def engine_case(system, requests, mesh, out: dict) -> None:
    """``IMPACTEngine.run`` on the sharded session, on every rank with the
    same requests and clock."""
    session = system.compile(RuntimeSpec(
        device="cpu", capacity=ENGINE_CAPACITY,
        topology=Topology(mesh=mesh)))
    eng = IMPACTEngine(session, clock=VirtualClock())
    assert eng.mesh is mesh
    preds, stats = eng.run(requests)
    out["engine/pred"] = preds
    out["engine/bills"] = np.array([r.e_read_j
                                    for r in eng.request_records])
    out["engine/meter"] = np.array(stats["energy"].read_energy_j)
    out["engine/traces"] = np.array(session.trace_count)


def _served(s, lits, buf, valid) -> list[torch.Tensor]:
    """Every serving entry of ``s`` on the session inputs, its outputs in
    order."""
    p = s.predict(lits)
    r = s.infer_step(buf, valid)
    got = [p.predictions, p.scores, r.predictions, r.e_clause_lanes,
           r.e_class_lanes]
    if s.meters_energy:
        rep = s.infer_with_report(buf, valid).report
        got.append(torch.tensor([rep.read_energy_j, rep.clause_energy_j,
                                 rep.class_energy_j], dtype=torch.float64))
    return got


def graphed_cases(system, lits, buf, valid, mesh, out: dict) -> None:
    """Each placement x packing x metering, served through staged graphs
    (the recorder stands in for the capture) and eagerly: every output,
    the stages a graph has, the captures, and ``trace_count`` before and
    after serving twice."""
    B = lits.shape[0]
    saved = {k: getattr(graphs, k) for k in ("enabled", "new_pool",
                                             "capture")}
    rec = patch(setattr, Recorder())
    try:
        for shard in PLACEMENTS:
            for pk in PACKINGS:
                for m in METERINGS:
                    spec = RuntimeSpec(device="cpu", metering=m, packing=pk,
                                       capacity=B, batch_sizes=(B,),
                                       topology=Topology(mesh=mesh,
                                                         shard=shard))
                    key = f"graph/{shard}/{pk}/{m}"
                    # New sessions, not the system's cached ones.
                    with rec.off():
                        eager = InferenceSession(system, spec)
                    n0 = len(rec.log)
                    s = InferenceSession(system, spec)
                    if m != "off":
                        s.warm(B, "infer_with_report")
                    before = s.trace_count
                    g = s.graph("infer_step", B)
                    out[f"{key}/stages"] = np.array(
                        [len(s.graph(e, B).stages)
                         for e, _ in s.compiled_shapes()])
                    out[f"{key}/captures"] = np.array(
                        sum(x[0] == "capture" for x in rec.log[n0:]
                            if isinstance(x, tuple)))
                    out[f"{key}/staged"] = np.array(
                        isinstance(g, graphs.StagedEntry)
                        and s.eager_reason("infer_step", B) is None)
                    for i in range(2):
                        for j, (a, b) in enumerate(zip(
                                _served(s, lits, buf, valid),
                                _served(eager, lits, buf, valid))):
                            out[f"{key}/{i}/{j}/graphed"] = a.numpy()
                            out[f"{key}/{i}/{j}/eager"] = b.numpy()
                    out[f"{key}/traces"] = np.array([before, s.trace_count])
    finally:
        for k, v in saved.items():
            setattr(graphs, k, v)


def replay_case(system, requests, mesh, out: dict) -> None:
    """``replay_trace`` on a ``time.monotonic`` engine over a sharded
    session: a seeded Poisson trace, every rank with the same arguments;
    what it completed, shed, predicted and billed."""
    session = system.compile(RuntimeSpec(
        device="cpu", capacity=ENGINE_CAPACITY,
        topology=Topology(mesh=mesh)))
    eng = IMPACTEngine(session, clock=time.monotonic)
    arrivals = poisson_arrivals(REPLAY_REQUESTS, REPLAY_RATE, seed=5)
    res = replay_trace(eng, requests, arrivals)
    assert eng.clock is time.monotonic
    recs = sorted(eng.request_records, key=lambda r: r.rid)
    out["replay/counts"] = np.array([res["offered"], res["completed"],
                                     res["shed"], len(recs)])
    out["replay/times"] = np.array([res["wall_s"], res["p50_s"],
                                    res["p99_s"]])
    out["replay/pred"] = np.array([r.pred for r in recs])
    out["replay/bills"] = np.array([r.e_read_j for r in recs])
    out["replay/meter"] = np.array(
        sum(rep.read_energy_j for rep in eng.reports))
    out["replay/traces"] = np.array(session.trace_count)
    # The same trace through a one-tenant zoo on the sharded session.
    zoo = ModelZoo(session, [("t", SLOClass())], clock=time.monotonic)
    res = replay_zoo_trace(zoo, [("t", row) for row in requests], arrivals)
    recs = sorted(zoo.request_records, key=lambda r: r.rid)
    out["zoo_replay/counts"] = np.array([res["completed"], res["shed"]])
    out["zoo_replay/pred"] = np.array([r.pred for r in recs])
    out["zoo_replay/bills"] = np.array([r.e_read_j for r in recs])


def world_main(rank: int, tmp: str) -> None:
    # Small operands: one thread a rank beats ranks competing for cores.
    torch.set_num_threads(1)
    world = dist.get_world_size()
    with open(os.path.join(tmp, "cases.json")) as f:
        spec = json.load(f)
    z = np.load(os.path.join(tmp, "inputs.npz"))
    out: dict = {}
    meshes: dict = {}

    def mesh_of(n_data: int, n_model: int):
        if (n_data, n_model) not in meshes:
            mesh = make_crossbar_mesh(n_model, device_type="cpu")
            assert axis_sizes(mesh) == dict(data=n_data, model=n_model)
            meshes[(n_data, n_model)] = mesh
        return meshes[(n_data, n_model)]

    for case in spec["cases"]:
        if case["world"] == world:
            lowering_case(z, case, mesh_of(*case["mesh"]), out)
    mesh = mesh_of(world // 2, 2)
    system = system_from_arrays(_system_arrays(z, spec["system"]),
                                device="cpu")
    lits = torch.from_numpy(z[f"{spec['system']}/lits"])
    buf = torch.from_numpy(z["session/buf"])
    valid = torch.from_numpy(z["session/valid"])
    session_cases(system, lits, buf, valid, mesh, out)
    shard_mode_cases(system, buf, valid, mesh, out)
    engine_case(system, z["session/requests"], mesh, out)
    graphed_cases(system, lits, buf, valid, mesh, out)
    replay_case(system, z["session/replay"], mesh, out)
    np.savez(os.path.join(tmp, f"w{world}_rank{rank}.npz"), **out)

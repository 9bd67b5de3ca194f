"""The port's static analysis (``repro_torch.analysis``) on the CPU, held to
the reference's ``tests/test_analysis.py`` contracts.

* The lint: each rule fires on a known-bad source in its scope and only
  there, waivers are counted, a syntax error is an unwaivable finding,
  the shipped ``src/repro_torch`` tree is clean, and the port's lint
  gives ``repro.analysis.lint``'s findings on the same toy sources, the
  paths mapped from ``src/repro`` to ``src/repro_torch``.
* The audit: the op-trace scans flag an f64 op, a sub-f32 operand, a
  product under TF32 and a host read inside an entry; fingerprints count
  ops and operand bytes and show drift; the SASS scan flags TF32 and f64
  outside the declared reduction; the resource parser reads a committed
  sample of nvcc's ``--resource-usage`` report for the four libraries
  (``tests/data/nvcc_resource_usage_sm90a.txt``, an sm_90a build by
  CUDA 12.8), whose kernels fit their planners' blocks an SM and the
  shared-memory estimates; every shipped spec's session audits clean,
  a too-small ``smem_budget_bytes`` is an error, and auditing prepares
  nothing.
"""
import importlib
import json
import pathlib
import re
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis import lint as ref_lint
from repro_torch.analysis import ir_audit, lint, smem
from repro_torch.core.cotm import CoTMConfig, CoTMParams
from repro_torch.impact import (IMPACTConfig, RuntimeSpec, build_coresident,
                                build_system)
from repro_torch.kernels import _build, backends

REPO = pathlib.Path(__file__).resolve().parent.parent
CSRC = REPO / "src" / "repro_torch" / "kernels" / "csrc"
SAMPLE = pathlib.Path(__file__).resolve().parent / "data" / \
    "nvcc_resource_usage_sm90a.txt"
SERVE = "src/repro_torch/serve/fixture.py"          # runtime-scoped path
KERNELS = "src/repro_torch/kernels/fixture.py"


def _lint(src: str, path: str = SERVE):
    return lint.lint_source(textwrap.dedent(src), path)


def _rules(findings, *, waived=False):
    return [f.rule for f in findings if f.waived == waived]


# -- the lint ----------------------------------------------------------------

ASSERT_SRC = """
def admit(reqs):
    assert reqs, "no requests"
    return reqs
"""
CLOCK_SRC = """
import time

class Engine:
    def __init__(self, clock=time.time):
        self.clock = clock

    def step(self):
        return time.monotonic()
"""
LANES_SRC = """
def bill(res):
    lanes = res.e_class_lanes
    total = lanes + lanes
    return sum(res.e_clause_lanes) + total
"""
BACKEND_SRC = """
class Backend:
    def fused_impact(self, literals, clause_i, *, thresh):
        raise NotImplementedError

    def crossbar_mvm(self, drive, g):
        raise NotImplementedError

def register_backend(b):
    pass

class Partial(Backend):
    def fused_impact(self, literals, *, thresh):   # wrong arity
        return literals

class Rogue:
    name = "rogue"

register_backend(Partial())
register_backend(Rogue())
"""
SHIM_SRC = """
def run(session, lits, mesh):
    session.predict(lits, impl="pallas")
    session.infer_step(lits, None, meter=True)
    helper(lits, meter_energy=True)
    other(lits, impl="not-a-shimmed-callee")
"""
WAIVED_SRC = """
def admit(reqs):
    assert reqs  # lint: waive IMPACT001 checked by caller
    return reqs
"""


def test_impact001_bare_assert_fires_in_scope_only():
    assert _rules(_lint(ASSERT_SRC)) == ["IMPACT001"]
    assert _rules(_lint(ASSERT_SRC, "src/repro_torch/impact/runtime.py")) \
        == ["IMPACT001"]
    assert _rules(_lint(ASSERT_SRC, KERNELS)) == []
    assert _rules(_lint(ASSERT_SRC, "src/repro/serve/fixture.py")) == []


def test_impact002_wall_clock_fires_only_with_injectable_clock():
    assert _rules(_lint(CLOCK_SRC)) == ["IMPACT002"]
    assert _rules(_lint("import time\n\ndef stamp():\n"
                        "    return time.time()\n")) == []
    assert _rules(_lint(CLOCK_SRC, KERNELS)) == []


def test_impact003_energy_sums_need_an_f64_cast():
    assert _rules(_lint(LANES_SRC)) == ["IMPACT003", "IMPACT003"]
    for cast in ("np.asarray(res.e_clause_lanes, np.float64)",
                 "res.e_clause_lanes.double()",
                 "res.e_clause_lanes.to(torch.float64)",
                 "torch.as_tensor(res.e_clause_lanes, dtype=torch.float64)"):
        assert _rules(_lint(f"def bill(res):\n    return sum({cast})\n")) \
            == [], cast
    assert _rules(_lint(LANES_SRC, KERNELS)) == []


def test_impact004_backend_conformance():
    rules = _rules(_lint(BACKEND_SRC, KERNELS))
    assert rules.count("IMPACT004") == 3
    good = BACKEND_SRC.split("class Partial")[0] + textwrap.dedent("""
    class Mine(Backend):
        def fused_impact(self, literals, clause_i, *, thresh, extra=None):
            return literals

        def crossbar_mvm(self, drive, g):
            return drive

    register_backend(Mine())
    """)
    assert _rules(_lint(good, KERNELS)) == []


def test_impact005_shim_kwargs_anywhere():
    """The port has no shim modules: no file is exempt."""
    for path in ("src/repro_torch/impact/ops.py",
                 "src/repro_torch/impact/pipeline.py",
                 "src/repro_torch/impact/runtime.py",
                 "src/repro_torch/serve/impact_engine.py"):
        assert _rules(_lint(SHIM_SRC, path)) == ["IMPACT005"] * 3, path


def test_waiver_suppresses_but_is_counted():
    findings = _lint(WAIVED_SRC)
    assert _rules(findings) == []
    assert _rules(findings, waived=True) == ["IMPACT001"]


def test_syntax_error_is_an_unwaivable_finding():
    assert _rules(_lint("def broken(:\n  # lint: waive SYNTAX\n")) \
        == ["SYNTAX"]


def test_shipped_tree_is_lint_clean():
    findings = lint.lint_tree(REPO)
    active = [f for f in findings if not f.waived]
    assert active == [], "\n".join(str(f) for f in active)
    assert len(lint.iter_target_files(REPO)) > 30
    assert all("repro_torch" in str(p) for p in lint.iter_target_files(REPO))


@pytest.mark.parametrize("src,sub", [
    (ASSERT_SRC, "serve/fixture.py"), (ASSERT_SRC, "kernels/fixture.py"),
    (CLOCK_SRC, "serve/fixture.py"), (LANES_SRC, "serve/fixture.py"),
    (BACKEND_SRC, "kernels/fixture.py"), (SHIM_SRC, "impact/ops.py"),
    (WAIVED_SRC, "serve/fixture.py"), ("def broken(:\n", "serve/x.py")])
def test_lint_agrees_with_reference(src, sub):
    ours = lint.lint_source(textwrap.dedent(src), f"src/repro_torch/{sub}")
    theirs = ref_lint.lint_source(textwrap.dedent(src), f"src/repro/{sub}")
    key = lambda fs: [(f.rule, f.line, f.waived,
                       f.path.replace("repro_torch", "repro")) for f in fs]
    assert key(ours) == key(theirs)


# -- op traces ---------------------------------------------------------------

def test_precision_and_host_scans_of_a_toy_entry():
    x = torch.ones(8, 10)

    def widening(t):
        y = t.double() * 2.0
        return y.sum().item()

    trace = ir_audit.record_ops(widening, (x,))
    checks = [f.check for f in ir_audit.audit_trace(trace)]
    assert "precision" in checks and "host_io" in checks
    assert any("f64" in f.message for f in ir_audit.scan_precision(trace))
    assert any("_local_scalar_dense" in f.message
               for f in ir_audit.scan_host_io(trace))
    clean = ir_audit.record_ops(lambda t: (t * 2).argmax(dim=-1), (x,))
    assert ir_audit.audit_trace(clean) == []
    half = ir_audit.record_ops(lambda t: t.to(torch.bfloat16) + 1, (x,))
    msgs = [f.message for f in ir_audit.scan_precision(half)]
    assert msgs and all("bf16" in m for m in msgs)
    f16 = ir_audit.record_ops(lambda t: t.half() + 1, (x,))
    msgs = [f.message for f in ir_audit.scan_precision(f16)]
    assert msgs and all("f16" in m and "bf16" not in m for m in msgs)


def test_tf32_products_are_flagged():
    a = torch.ones(4, 8)
    mm = lambda t: t @ t.T
    assert ir_audit.scan_precision(ir_audit.record_ops(mm, (a,))) == []
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        trace = ir_audit.record_ops(mm, (a,))
    finally:
        torch.set_float32_matmul_precision(before)
    assert "[tf32]" in trace
    assert any("TF32" in f.message for f in ir_audit.scan_precision(trace))


def test_fingerprint_counts_ops_and_operand_bytes():
    trace = ("kernel fused_impact_f32(i8[8,64], f32[1,1,64,32], b8[32], "
             "f32[1,32,4]) -> f32[8,4]\n"
             "aten.argmax.default(f32[8,4]) -> i64[8]\n")
    fp = ir_audit.fingerprint_text(trace)
    assert fp["ops"] == {"aten.argmax.default": 1,
                         "kernel fused_impact_f32": 1}
    assert fp["n_ops"] == 2
    assert fp["operand_bytes"] == (8 * 64 + 4 * 64 * 32 + 32 + 4 * 32 * 4
                                   + 4 * 8 * 4)
    drift = ir_audit.fingerprint_text(trace.replace("argmax", "argmin"))
    deltas = ir_audit.diff_fingerprints(fp, drift)
    assert any("argmax" in d for d in deltas)
    assert ir_audit.diff_fingerprints(fp, fp) == []
    bigger = ir_audit.fingerprint_text(trace.replace("i8[8,64]", "i8[9,64]"))
    assert any("operand bytes" in d
               for d in ir_audit.diff_fingerprints(fp, bigger))


# -- compiled kernels --------------------------------------------------------

def _sass(name: str, *instructions: str) -> str:
    lines = [f"\t\tFunction : {name}"]
    lines += [f"        /*{16 * i:04x}*/                   {ins} ;"
              f"                /* 0x000000000000 */"
              for i, ins in enumerate(instructions)]
    return "\n".join(lines) + "\n"


TAIL = "_ZN48_GLOBAL__N__5b68df1e_15_fused_impact_cu_968572f211impact_tailILb1EEEvPKfPKhS2_PfS5_S5_iiiiiiif"
TILES = "_ZN48_GLOBAL__N__0f1f4cde_15_crossbar_mvm_cu_0db5c7d19mvm_tilesILb0ELb1EEEvPKfS2_Pfiiiifff"


def test_sass_scan():
    ok = _sass(TAIL, "DADD R16, RZ, R16", "DFMA R2, R4, R6, R2") + \
        _sass(TILES, "FFMA R3, R4, R5, R3")
    assert ir_audit.scan_sass(ok) == []
    assert ir_audit.f64_kernels(ok) == ["impact_tail<1>"]
    bad = ok + _sass(TILES, "DMUL R2, R4, R6")
    msgs = [f.message for f in ir_audit.scan_sass(bad)]
    assert len(msgs) == 1 and msgs[0].startswith("mvm_tiles<0,1>: 1 f64")
    tf32 = _sass(TILES, "HMMA.1684.F32.TF32 R4, R8, R12, R4")
    msgs = [f.message for f in ir_audit.scan_sass(tf32)]
    assert len(msgs) == 1 and "TF32" in msgs[0]


def test_kernel_names_demangle():
    assert _build.kernel_name(TAIL) == "impact_tail<1>"
    assert _build.kernel_name(TILES) == "mvm_tiles<0,1>"
    assert _build.kernel_name("_Z16class_sum_kernelILi4EEvPKaPKiPiiii") \
        == "class_sum_kernel<4>"
    assert _build.kernel_name("not_mangled") == "not_mangled"


@pytest.fixture(scope="module")
def sample_tables():
    text = SAMPLE.read_text()
    chunks = re.split(r"(?=ptxas info    : 0 bytes gmem)", text)
    by_source = {}
    for chunk in filter(str.strip, chunks):
        table = _build.parse_resources(chunk)
        src = {"mvm": "crossbar_mvm.cu", "imp": "fused_impact.cu",
               "pac": "fused_impact.cu", "ta_": "ta_feedback.cu",
               "fus": "digital_cotm.cu", "cla": "digital_cotm.cu",
               "fla": "flash_mla.cu"}[
            next(iter(table))[:3]]
        by_source[src] = table
    return by_source


def test_resource_report_parses(sample_tables):
    assert set(sample_tables) == set(_build.SOURCES)
    mvm = sample_tables["crossbar_mvm.cu"]
    assert mvm["mvm_tiles<0,0>"] == _build.Resources(
        registers=80, smem=27648, stack=8, spill_stores=8, spill_loads=8)
    assert mvm["mvm_reduce"].smem == 0
    # impact_tiles<LIT,VC,PAIRED> x 8, packed_tiles x 4, impact_tail x 4
    fused = sample_tables["fused_impact.cu"]
    assert len(fused) == 16
    assert fused["impact_tiles<16,1,1>"].smem == 46080
    assert fused["impact_tiles<16,1,0>"].smem == 30720
    assert sample_tables["digital_cotm.cu"]["class_sum_kernel<4>"] \
        .registers == 48
    with pytest.raises(ValueError, match="registers"):
        _build.parse_resources("ptxas info    : 0 bytes gmem\n")


@pytest.mark.parametrize("registers,threads,smem_b,blocks", [
    (80, 256, 27648, 3), (128, 256, 1920, 2), (95, 256, 31488, 2),
    (64, 512, 16512, 2), (128, 512, 21504 + 98304, 1), (38, 256, 0, 6),
    (32, 64, 0, 32), (0, 256, 0, 8), (16, 32, 120 * 1024, 1)])
def test_blocks_per_sm(registers, threads, smem_b, blocks):
    assert smem.blocks_per_sm(registers, threads, smem_b) == blocks


def test_sample_kernels_fit_their_plans(sample_tables, monkeypatch):
    sets = smem.all_working_sets()
    assert {w.variant for w in sets} == {
        k.split("<")[0] for t in sample_tables.values() for k in t}
    assert ir_audit.resource_findings(sets, sample_tables) == []
    # A planner that assumed five blocks an SM would be wrong for the
    # tail (at most 64 registers x 256 threads allow four): the check
    # bites.
    monkeypatch.setattr(importlib.import_module(
        "repro_torch.kernels.fused_impact"), "TAIL_BLOCKS_PER_SM", 5)
    bad = ir_audit.resource_findings(sets, sample_tables)
    assert {f.message.split(":")[0] for f in bad} == {
        "impact_tail<0,1>", "impact_tail<0,4>", "impact_tail<1,1>",
        "impact_tail<1,4>"}
    assert all(f.check == "occupancy" and f.severity == "error"
               for f in bad)


def test_estimate_under_the_report_is_flagged(sample_tables):
    tables = {k: dict(v) for k, v in sample_tables.items()}
    tables["fused_impact.cu"]["impact_tiles<1,1,1>"] = _build.Resources(
        64, 50000, 0, 0, 0)
    bad = ir_audit.resource_findings(smem.all_working_sets(), tables)
    assert [f.check for f in bad] == ["smem"]


def _constants(path: pathlib.Path) -> dict[str, int]:
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", path.read_text())}


def test_block_constants_match_the_sources():
    mvm, fi, cs = (importlib.import_module(f"repro_torch.kernels.{m}")
                   for m in ("crossbar_mvm", "fused_impact", "class_sum"))
    c = _constants(CSRC / "crossbar_mvm.cu")
    assert (mvm.TILE_B, mvm.TILE_N, mvm.STAGE_K, mvm.STAGES, mvm.THREADS,
            mvm.NARROW_THREADS, mvm.APAD) == (
        c["BM"], c["BN"], c["BK"], c["STAGES"], 256, c["NARROW_THREADS"],
        c["BK"] + 4)
    c = _constants(CSRC / "fused_impact.cu")
    assert fi.F32_TILE == (c["BM"], c["BN"], c["BK"])
    assert (fi.STAGES, fi.TAIL_THREADS, fi.TAIL_BLOCKS_PER_SM,
            fi.TAIL_FIRED_WORDS, fi.TAIL_CLASSES, fi.TAIL_LIST,
            fi.PACKED_BLOCKS_PER_SM) == (
        c["STAGES"], c["TAIL_THREADS"], c["TAIL_BLOCKS"],
        c["FIRED_WORDS"], c["MT"], c["LIST"], c["PACKED_BLOCKS"])
    c = _constants(CSRC / "digital_cotm.cu")
    assert (cs.CS_LANES, cs.CS_CLASSES, cs.CS_CLAUSES) == (
        c["CS_LANES"], c["CS_MT"], c["CS_NC"])


def test_working_sets_fit_the_card():
    for ws in smem.all_working_sets():
        assert 0 <= ws.smem_bytes <= smem.DEFAULT_SMEM_BUDGET_BYTES, ws
        assert ws.register_file <= smem.REGISTERS_PER_SM
    f32, tail = smem.fused_working_sets(packed=False)
    packed, tail_p = smem.fused_working_sets(packed=True)
    # The f32 estimate is the paired ring's (both rows and both literals
    # of 16 pairs a stage); the packed one is the full ring and its codes.
    assert (f32.smem_bytes, packed.smem_bytes) == (46080, 31488)
    assert tail_p == tail and tail.smem_static == 34880


# -- session audits ----------------------------------------------------------

@pytest.fixture(scope="module")
def small_system():
    K, n, m, n_states = 64, 32, 4, 64
    rng = np.random.default_rng(0)
    ta = np.where(rng.random((K, n)) < 0.1, n_states + 1, n_states)
    w = rng.integers(-20, 20, (m, n))
    params = CoTMParams(ta_state=torch.as_tensor(ta, dtype=torch.int32),
                        weights=torch.as_tensor(w, dtype=torch.int32))
    return build_system(params, CoTMConfig(K, n, m, n_states), None,
                        IMPACTConfig(variability=False, finetune=False),
                        device="cpu")


@pytest.mark.parametrize("backend", ["cuda", "torch", "cuda-packed",
                                     "cuda-metered"])
@pytest.mark.parametrize("metering", ["off", "fused", "staged"])
@pytest.mark.parametrize("packing", ["none", "2bit"])
def test_every_shipped_spec_passes_the_audit(small_system, backend,
                                             metering, packing):
    sess = small_system.compile(RuntimeSpec(
        backend=backend, metering=metering, packing=packing, device="cpu",
        capacity=8, batch_sizes=(8,)))
    sess.warm(16, "ta_feedback")
    report = sess.audit()
    assert report.ok, [str(f) for f in report.findings]
    assert set(report.fingerprints) == {"predict@8", "infer_step@8",
                                        "ta_feedback@16"}
    if backend == "torch":
        assert report.smem_bytes == {}
    else:
        assert all(v > 0 for v in report.smem_bytes.values())
        assert "kernel " in sess.ir_text("infer_step", 8)
    json.dumps(report.to_json())


def test_coresident_sessions_pass_the_audit(small_system):
    combined, plan = build_coresident([small_system, small_system])
    for metering in ("off", "fused", "staged"):
        sess = combined.compile(RuntimeSpec(
            coresident=plan, metering=metering, device="cpu", capacity=8))
        report = sess.audit()
        assert report.ok, [str(f) for f in report.findings]
        assert "kernel crossbar_mvm_f32" in sess.ir_text("infer_step", 8)


def test_primitives_trace_as_one_line(small_system):
    """A "cuda" session's trace names the kernel and hides the plain
    version the wrapper runs on the CPU; the "torch" session's trace
    shows the plain version's ops."""
    cuda = small_system.compile(RuntimeSpec(metering="off", device="cpu"))
    plain = small_system.compile(RuntimeSpec(backend="torch",
                                             metering="off", device="cpu"))
    lines = cuda.ir_text("predict", 8).splitlines()
    assert lines[0].startswith("kernel fused_impact_f32(i8[8,64], ")
    assert lines[0].endswith("-> f32[8,4]")
    assert not any("einsum" in ln or "bmm" in ln for ln in lines)
    assert not plain.ir_text("predict", 8).startswith("kernel ")


def test_smem_busting_spec_is_flagged(small_system):
    sess = small_system.compile(RuntimeSpec(
        metering="fused", batch_sizes=(8,), device="cpu",
        smem_budget_bytes=1024))
    report = sess.audit()
    assert not report.ok
    assert any(f.check == "smem" and f.severity == "error"
               for f in report.findings)


def test_fingerprint_drift_is_detected(small_system):
    sess = small_system.compile(RuntimeSpec(metering="off",
                                            batch_sizes=(8,), device="cpu"))
    base = dict(sess.audit().fingerprints)
    clean = sess.audit(baselines=base)
    assert not any(f.check == "fingerprint" for f in clean.findings)
    perturbed = {k: {"ops": {"aten.add.Tensor": 1}, "n_ops": 1}
                 for k in base}
    drifted = sess.audit(baselines=perturbed)
    assert any(f.check == "fingerprint" and f.severity == "warning"
               for f in drifted.findings)
    assert drifted.ok
    missing = sess.audit(baselines={})
    assert any("no fingerprint baseline" in f.message
               for f in missing.findings)


def test_auditing_adds_no_preparation(small_system):
    sess = small_system.compile(RuntimeSpec(metering="off",
                                            batch_sizes=(4,), device="cpu"))
    before = (sess.trace_count, sess.compiled_shapes())
    sess.audit()
    report = sess.audit("predict", 16)       # not prepared: still no trace
    assert "predict@16" in report.fingerprints
    sess.ir_text("infer_step", 4)
    assert (sess.trace_count, sess.compiled_shapes()) == before
    with pytest.raises(ValueError, match="no prepared entries"):
        ir_audit.audit_session(sess, "infer_with_report", None)
    with pytest.raises(RuntimeError, match="metering='off'"):
        sess.ir_text("infer_with_report", 4)


def test_spec_validates_smem_budget():
    with pytest.raises(ValueError, match="smem_budget_bytes"):
        RuntimeSpec(smem_budget_bytes=0)
    assert RuntimeSpec(smem_budget_bytes=1).smem_budget_bytes == 1


def test_reference_backend_flag():
    assert backends.get_backend("torch").reference
    assert not any(backends.get_backend(b).reference
                   for b in ("cuda", "cuda-packed", "cuda-metered"))


def test_profile_window_needs_a_card(monkeypatch):
    from repro_torch.analysis import profile_window
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        profile_window.main(["--windows", "1"])
    assert profile_window.MARGIN_S > 0

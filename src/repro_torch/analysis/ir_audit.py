"""Static audit of what a compiled session serves: its op traces, its
kernels' working sets and, on a card, the kernels as compiled.

PyTorch runs eagerly, so the port has no StableHLO to read.  Its
counterpart is the op trace (``InferenceSession.ir_text``), recorded by
``record_ops`` under a ``TorchDispatchMode`` and the kernel wrappers'
launch hook (``kernels._build.launch_hook``): one line for each primitive
call, named by the kernel it launches on ``"cuda"``, and one line for each
aten op outside the primitives, each with its operands' dtypes and
shapes, as ``aten.argmax.default(f32[8,10]) -> i64[8]``.  The checks:

* **Precision ladder** (error).  The analog datapath is IEEE f32 from
  end to end and bills are summed in f64 on the host, after the copy.
  So a trace holds no f64 (billing or a numpy float64 leaking onto the
  device), no f16 or bf16 (a meter accumulating below f32), and no
  matrix product or convolution under TF32 (``[tf32]``: f32 products
  with TF32 allowed, which breaks the scores' rtol of 1e-6).  In the
  compiled kernels (``scan_sass`` over ``cuobjdump -sass``) there is no
  TF32 instruction anywhere, and f64 arithmetic (``DADD`` / ``DFMA`` /
  ``DMUL``) only in the kernels listed in ``F64_REDUCTIONS``.  That list
  is the port's own rung of the ladder: ``impact_tail`` (both of its
  variants, ``fused_impact.cu``) sums each lane's class scores, and
  metered its clause and class meters, in f64 in a fixed order and
  rounds once to f32, so that the scores and meters are the same from
  run to run and hold the reference's f32 tolerances; the paired
  ``impact_tiles`` sums each column's negation rows in f64 in a fixed
  order and rounds once, a term every lane's current shares; their
  inputs and outputs are f32.  Any other kernel with f64 arithmetic is
  an error.
* **Host isolation** (error): no device-to-host transfer inside an entry
  (``aten._local_scalar_dense``, which ``.item()`` and ``int()`` /
  ``float()`` of a tensor run, or a copy from the card to the host,
  marked ``[to host]``): a sweep that waits on the host serializes every
  scheduler sweep.
* **Working set** (error): each kernel's shared memory a block
  (``analysis.smem``) within ``RuntimeSpec.smem_budget_bytes``; on a
  card, the blocks an SM each compiled kernel's reported registers and
  shared memory allow against the blocks its planner assumes, and the
  estimate at least what nvcc reports.
* **Graph** (error, on a card): every prepared entry is one captured
  CUDA graph (``impact.graphs``; a sharded serving entry one graph a
  local stage), unless the session names a reason it runs eagerly
  (``InferenceSession.eager_reason``: no lane at B = 0), which the audit
  reports as an ``"info"`` finding;
  the launches its kernel wrappers made at capture are the trace's
  primitive lines, symbol for symbol; and the graph holds as many
  kernel nodes of the port's sources as the entry's kernels launch
  (``cost_analysis``' ``launches``; none on a reference backend), so no
  launch escaped the capture or was captured twice; a staged entry's
  every stage holds the nodes priced for it
  (``InferenceSession.stage_launches``).
* **Fingerprint** (warning): a histogram of the trace's primitives and
  ops plus its operand bytes, diffed against committed ``baselines``
  when given: a change that reroutes a session shows even where the
  numbers still pass.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import _build
from . import smem

#: Kernels (their names in the CUDA sources) that declare an f64
#: reduction: the only ones whose SASS may hold f64 arithmetic.
F64_REDUCTIONS = ("impact_tail", "impact_tiles")


@dataclasses.dataclass(frozen=True)
class AuditFinding:
    """One violation in one entry's trace, working set or kernels."""
    check: str     # "precision" | "host_io" | "smem" | "occupancy" | "graph" | "fingerprint"
    severity: str  # "error" (fails ``ok``), "warning" or "info"
    entry: str     # session entry ("predict", ...) or a kernel source
    batch: int
    message: str
    line: int | None = None   # 1-based line in the trace, when anchored

    def __str__(self) -> str:
        where = f"{self.entry}@{self.batch}"
        if self.line is not None:
            where += f":{self.line}"
        return f"[{self.check}] {where}: {self.message}"


@dataclasses.dataclass(frozen=True)
class AuditReport:
    """Every finding plus the evidence the audit read: fingerprints and
    the largest block's shared memory, by ``"entry@batch"``."""
    findings: tuple[AuditFinding, ...]
    fingerprints: dict[str, dict[str, Any]]
    smem_bytes: dict[str, int]
    smem_budget_bytes: int

    @property
    def ok(self) -> bool:
        return not any(f.severity == "error" for f in self.findings)

    def to_json(self) -> dict[str, Any]:
        return {"ok": self.ok,
                "findings": [dataclasses.asdict(f) for f in self.findings],
                "fingerprints": self.fingerprints,
                "smem_bytes": self.smem_bytes,
                "smem_budget_bytes": self.smem_budget_bytes}


# -- recording an op trace --------------------------------------------------

_DTYPES = {torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
           torch.bfloat16: "bf16", torch.int64: "i64", torch.int32: "i32",
           torch.int16: "i16", torch.int8: "i8", torch.uint8: "u8",
           torch.bool: "b8"}
_ITEMSIZE = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "i64": 8, "i32": 4,
             "i16": 2, "i8": 1, "u8": 1, "b8": 1}
_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "dot",
             "mv", "linear", "convolution", "_convolution", "cudnn_convolution"}


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def _sig(x) -> str:
    return ", ".join(
        f"{_DTYPES.get(t.dtype, str(t.dtype))}[{','.join(map(str, t.shape))}]"
        for t in _tensors(x))


def _tf32(name: str, ins: list[torch.Tensor]) -> bool:
    """A product on f32 operands while TF32 is allowed for it."""
    if name not in _PRODUCTS or not any(t.dtype == torch.float32
                                        for t in ins):
        return False
    if "conv" in name:
        return bool(torch.backends.cudnn.allow_tf32)
    return (bool(torch.backends.cuda.matmul.allow_tf32)
            or torch.get_float32_matmul_precision() != "highest")


class _Recorder(TorchDispatchMode):
    """Records one line per aten op, except inside a primitive call, which
    the launch hook records as one line."""

    def __init__(self):
        super().__init__()
        self.lines: list[str] = []
        self._inside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self._inside:
            ins = _tensors((args, kwargs))
            outs = _tensors(out)
            line = f"{func}({_sig(ins)}) -> {_sig(outs)}"
            if _tf32(func.overloadpacket.__name__, ins):
                line += " [tf32]"
            if (any(t.device.type == "cuda" for t in ins)
                    and any(t.device.type == "cpu" for t in outs)):
                line += " [to host]"
            self.lines.append(line)
        return out

    def hook(self, symbol, fn, args, kwargs):
        self._inside += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._inside -= 1
        if not self._inside:
            self.lines.append(
                f"kernel {symbol}({_sig((args, kwargs))}) -> {_sig(out)}")
        return out


def record_ops(fn, args: Iterable) -> str:
    """Run ``fn(*args)`` once and return its op trace, one line an op."""
    rec = _Recorder()
    with _build.launch_hook(rec.hook), rec:
        fn(*args)
    return "\n".join(rec.lines) + "\n"


# -- scans of a trace -------------------------------------------------------

_F64_RE = re.compile(r"\bf64\[")
_BF16_RE = re.compile(r"\bbf16\[")
_F16_RE = re.compile(r"(?<![\w])f16\[")
_HOST_IO_RE = re.compile(r"aten\._local_scalar_dense\b|aten\.item\b|"
                         r"\[to host\]")


def scan_precision(trace: str, *, entry: str = "?",
                   batch: int = 0) -> list[AuditFinding]:
    """Flag every trace line with an f64, bf16 or f16 operand, or a
    product under TF32."""
    findings = []
    for i, line in enumerate(trace.splitlines(), start=1):
        for pat, what in ((_F64_RE, "f64 operand in the entry: billing "
                                    "widens to f64 on the host, after the "
                                    "copy; the device path is f32"),
                          (_BF16_RE, "bf16 operand in the entry: a meter "
                                     "below f32 loses billing precision"),
                          (_F16_RE, "f16 operand in the entry: a meter "
                                    "below f32 loses billing precision")):
            if pat.search(line):
                findings.append(AuditFinding("precision", "error", entry,
                                             batch, what, line=i))
                break
        if line.endswith("[tf32]") or "[tf32] " in line:
            findings.append(AuditFinding(
                "precision", "error", entry, batch,
                "f32 product under TF32: about 1e-3 relative error "
                "against the scores' rtol of 1e-6", line=i))
    return findings


def scan_host_io(trace: str, *, entry: str = "?",
                 batch: int = 0) -> list[AuditFinding]:
    """Flag device-to-host transfers: scalar reads and copies to the
    host."""
    findings = []
    for i, line in enumerate(trace.splitlines(), start=1):
        m = _HOST_IO_RE.search(line)
        if m:
            findings.append(AuditFinding(
                "host_io", "error", entry, batch,
                f"device-to-host transfer ({m.group(0)}) in the entry: a "
                "sweep must not wait on the host", line=i))
    return findings


def audit_trace(trace: str, *, entry: str = "trace",
                batch: int = 0) -> list[AuditFinding]:
    """Precision and host isolation of a bare op trace."""
    return (scan_precision(trace, entry=entry, batch=batch)
            + scan_host_io(trace, entry=entry, batch=batch))


# -- fingerprints -----------------------------------------------------------

_LINE_RE = re.compile(r"^(kernel \w+|[\w.]+)\((.*?)\) ->")
_OPERAND_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def fingerprint_text(trace: str) -> dict[str, Any]:
    """Histogram of a trace's primitives and ops, and the bytes of their
    operands: two traces with the same fingerprint run the same kernels
    and ops on operands of the same sizes."""
    hist: dict[str, int] = {}
    operand_bytes = 0
    for line in trace.splitlines():
        m = _LINE_RE.match(line)
        if m is None:
            continue
        hist[m.group(1)] = hist.get(m.group(1), 0) + 1
        for dt, dims in _OPERAND_RE.findall(m.group(2)):
            n = 1
            for d in filter(None, dims.split(",")):
                n *= int(d)
            operand_bytes += n * _ITEMSIZE.get(dt, 0)
    return {"ops": dict(sorted(hist.items())), "n_ops": sum(hist.values()),
            "operand_bytes": operand_bytes}


def diff_fingerprints(baseline: dict[str, Any],
                      current: dict[str, Any]) -> list[str]:
    """Readable deltas of the histogram and the operand bytes (an empty
    list is a match)."""
    deltas = []
    b_ops, c_ops = baseline.get("ops", {}), current.get("ops", {})
    for op in sorted(set(b_ops) | set(c_ops)):
        b, c = b_ops.get(op, 0), c_ops.get(op, 0)
        if b != c:
            deltas.append(f"{op}: {b} -> {c}")
    b, c = baseline.get("operand_bytes"), current.get("operand_bytes")
    if b is not None and b != c:
        deltas.append(f"operand bytes: {b} -> {c}")
    return deltas


# -- compiled kernels -------------------------------------------------------

_FUNCTION_RE = re.compile(r"Function\s*:\s*(\S+)")
_TF32_RE = re.compile(r"tf32", re.IGNORECASE)
_F64_OPS_RE = re.compile(r"\b(DADD|DFMA|DMUL)\b")


def _sass_counts(sass: str) -> dict[tuple[str, str], int]:
    """TF32 and f64-arithmetic instructions of each kernel in
    ``cuobjdump -sass`` text: {(kernel, "tf32" | "f64"): count}."""
    counts: dict[tuple[str, str], int] = {}
    name = "?"
    for line in sass.splitlines():
        m = _FUNCTION_RE.search(line)
        if m:
            name = _build.kernel_name(m.group(1))
        elif "/*" in line:                     # an instruction
            for kind, pat in (("tf32", _TF32_RE), ("f64", _F64_OPS_RE)):
                if pat.search(line):
                    counts[(name, kind)] = counts.get((name, kind), 0) + 1
    return counts


def f64_kernels(sass: str) -> list[str]:
    """The kernels of ``cuobjdump -sass`` text with f64 arithmetic."""
    return [name for name, kind in _sass_counts(sass) if kind == "f64"]


def scan_sass(sass: str, *, source: str = "?",
              f64_allowed: Iterable[str] = F64_REDUCTIONS,
              ) -> list[AuditFinding]:
    """Flag TF32 instructions in any kernel, and f64 arithmetic in a
    kernel not listed in ``f64_allowed``, in ``cuobjdump -sass`` text:
    one finding a kernel and kind, with its count."""
    allowed = set(f64_allowed)
    return [AuditFinding(
        "precision", "error", source, 0,
        f"{name}: {n} TF32 instruction(s); the kernels are IEEE f32"
        if kind == "tf32" else
        f"{name}: {n} f64 instruction(s) (DADD/DFMA/DMUL) in a kernel that "
        f"declares no f64 reduction (ir_audit.F64_REDUCTIONS)")
        for (name, kind), n in sorted(_sass_counts(sass).items())
        if kind == "tf32" or name.split("<")[0] not in allowed]


def resource_findings(sets: Iterable[smem.WorkingSet],
                      tables: dict[str, dict[str, _build.Resources]], *,
                      entry: str = "?", batch: int = 0,
                      ) -> list[AuditFinding]:
    """Each working set against its compiled variants' reports (``tables``
    maps a source to ``_build.resource_table``): the estimate at least
    the reported shared memory, and the blocks an SM the registers and
    shared memory allow at least what the kernel's planner assumes (one
    where none does)."""
    planned = smem.planned_blocks()
    findings = []
    for ws in sets:
        variants = {k: r for k, r in tables[ws.source].items()
                    if k.split("<")[0] == ws.variant}
        if not variants:
            findings.append(AuditFinding(
                "occupancy", "error", entry, batch,
                f"{ws.variant}: no compiled kernel of that name in "
                f"{ws.source}'s resource report"))
        for name, res in sorted(variants.items()):
            if res.smem > ws.smem_static:
                findings.append(AuditFinding(
                    "smem", "error", entry, batch,
                    f"{name}: nvcc reports {res.smem} B of static shared "
                    f"memory, the estimate is {ws.smem_static} B"))
            blocks = smem.blocks_per_sm(res.registers, ws.threads,
                                        res.smem + ws.smem_dynamic)
            want = planned.get(ws.variant, 1)
            if blocks < want:
                findings.append(AuditFinding(
                    "occupancy", "error", entry, batch,
                    f"{name}: {res.registers} registers x {ws.threads} "
                    f"threads and {res.smem + ws.smem_dynamic} B of shared "
                    f"memory allow {blocks} block(s) an SM; its plan "
                    f"assumes {want}"))
    return findings


# -- captured graphs --------------------------------------------------------

_KERNEL_LINE_RE = re.compile(r"^kernel (\w+)\(", re.MULTILINE)


def traced_launches(trace: str) -> dict[str, int]:
    """The primitive calls of an op trace, by the C symbol they launch."""
    counts: dict[str, int] = {}
    for sym in _KERNEL_LINE_RE.findall(trace):
        counts[sym] = counts.get(sym, 0) + 1
    return counts


def graph_findings(graph, trace: str, port_launches, *,
                   entry: str = "?", batch: int = 0,
                   reason: str | None = None) -> list[AuditFinding]:
    """One prepared entry on a card against its op trace: ``graph`` (an
    ``impact.graphs.GraphedEntry``, or None where the entry runs eagerly)
    must exist unless the batch is empty or ``reason`` says why the entry
    runs eagerly (then one ``"info"`` finding names it), must have
    recorded at capture the trace's launches, and its census must hold
    ``port_launches`` kernel nodes of the port's sources: an int, or a
    sequence of one count a stage (``InferenceSession.stage_launches``),
    against which each stage's own census is held as well, and which
    must show a kernel node where the stage recorded a launch."""
    per_stage = ([int(port_launches)] if isinstance(port_launches, int)
                 else [int(n) for n in port_launches])
    port_launches = sum(per_stage)
    traced = traced_launches(trace)
    if graph is None:
        if reason is not None:
            return [AuditFinding("graph", "info", entry, batch,
                                 f"runs eagerly: {reason}")]
        if batch > 0:
            return [AuditFinding(
                "graph", "error", entry, batch,
                "not one captured CUDA graph: the entry runs eagerly")]
        return []
    findings = []
    if graph.launches != traced:
        findings.append(AuditFinding(
            "graph", "error", entry, batch,
            f"the capture recorded the launches {graph.launches}, the "
            f"trace {traced}"))
    nodes = graph.census.port_kernels
    if nodes != port_launches:
        findings.append(AuditFinding(
            "graph", "error", entry, batch,
            f"the graph holds {nodes} kernel node(s) of the port's sources, "
            f"the entry's kernels launch {port_launches} "
            f"({graph.census.describe()})"))
    stages = getattr(graph, "stages", None)
    if stages is not None and len(per_stage) > 1:
        if len(stages) != len(per_stage):
            findings.append(AuditFinding(
                "graph", "error", entry, batch,
                f"{len(stages)} captured stage(s), the entry prices "
                f"{len(per_stage)}"))
        for i, ((cap, _), want) in enumerate(zip(stages, per_stage)):
            nodes = cap.census.port_kernels
            if nodes != want or bool(cap.launches) != bool(nodes):
                findings.append(AuditFinding(
                    "graph", "error", entry, batch,
                    f"stage {i} holds {nodes} kernel node(s) of the port's "
                    f"sources, its capture recorded "
                    f"{_build.record_symbols(cap.launches)} and the entry "
                    f"prices {want} for it "
                    f"({cap.census.describe()})"))
    return findings


# -- the session-level audit ------------------------------------------------

def _keys(session, entry, batch) -> list[tuple[str, int]]:
    if entry is not None and batch is not None:
        return [(entry, int(batch))]
    keys = session.compiled_shapes(entry)
    if not keys:
        raise ValueError(
            "session has no prepared entries to audit: call "
            "session.warm(batch, entry) (or set capacity / batch_sizes on "
            "the spec) first, or name an (entry, batch)")
    return keys


def audit_session(session, entry: str | None = None,
                  batch: int | None = None, *,
                  baselines: dict[str, dict[str, Any]] | None = None,
                  ) -> AuditReport:
    """Audit the session's prepared entries (all of them by default, or
    the one ``(entry, batch)`` pair, which need not be prepared).

    ``baselines`` maps ``"entry@batch"`` to a fingerprint; a mismatch or
    a missing baseline is a warning.  On a card (a session on a CUDA
    device whose backend launches kernels) the kernels the entries
    launch are also checked against nvcc's resource report, and their
    sources' SASS is scanned; building them raises where ``nvcc`` or
    ``cuobjdump`` is missing.  On a card, whatever the backend, every
    prepared entry is held to its captured graph (``graph_findings``)."""
    findings: list[AuditFinding] = []
    fingerprints: dict[str, dict[str, Any]] = {}
    smem_bytes: dict[str, int] = {}
    budget = (session.spec.smem_budget_bytes
              or smem.DEFAULT_SMEM_BUDGET_BYTES)
    on_card = (session.device.type == "cuda"
               and not getattr(session.backend, "reference", False))
    sources: set[str] = set()

    for e, b in _keys(session, entry, batch):
        trace = session.ir_text(e, b)
        tag = f"{e}@{b}"
        findings += audit_trace(trace, entry=e, batch=b)
        fingerprints[tag] = fingerprint_text(trace)

        ws = smem.session_working_set(session, e, b)
        if ws is not None:
            smem_bytes[tag] = ws.smem_bytes
            if ws.smem_bytes > budget:
                findings.append(AuditFinding(
                    "smem", "error", e, b,
                    f"{ws.variant} takes {ws.smem_bytes} B of shared memory "
                    f"a block, over the budget of {budget} B"))
        if session.graphed and session.is_compiled(e, b):
            port = session.stage_launches(e, b)
            if getattr(session.backend, "reference", False):
                port = [0] * len(port)
            findings += graph_findings(session.graph(e, b), trace, port,
                                       entry=e, batch=b,
                                       reason=session.eager_reason(e, b))
        if on_card:
            sets = smem.entry_working_sets(session, e, b)
            tables = {w.source: _build.resource_table(w.source)
                      for w in sets}
            findings += resource_findings(sets, tables, entry=e, batch=b)
            sources.update(w.source for w in sets)

        if baselines is not None:
            base = baselines.get(tag)
            if base is None:
                findings.append(AuditFinding(
                    "fingerprint", "warning", e, b,
                    "no fingerprint baseline for this entry"))
            else:
                deltas = diff_fingerprints(base, fingerprints[tag])
                if deltas:
                    findings.append(AuditFinding(
                        "fingerprint", "warning", e, b,
                        "trace drifted from its baseline: "
                        + "; ".join(deltas[:8])
                        + ("; ..." if len(deltas) > 8 else "")))

    for src in sorted(sources):
        findings += scan_sass(_build.sass(src), source=src)
    return AuditReport(findings=tuple(findings), fingerprints=fingerprints,
                       smem_bytes=smem_bytes, smem_budget_bytes=budget)

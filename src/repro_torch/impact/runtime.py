"""Compiled-session runtime: ``RuntimeSpec`` -> ``InferenceSession`` (the
PyTorch port of ``repro.impact.runtime`` for one device).

A frozen ``RuntimeSpec`` (backend name, metering mode, precision,
packing, slot capacity, device) is resolved ONCE by
``IMPACTSystem.compile(spec)`` into an ``InferenceSession``: the backend
is looked up in the registry, the weight-side operands are placed on the
spec's device, and each ``(entry, batch)`` the session will serve is
prepared.  PyTorch runs eagerly, so "prepared" binds the entry's routing
for that batch shape; ``trace_count`` counts the prepared entries, which
serving must never grow.  CUDA graphs per ``(entry, batch)`` come later.

Routing follows the reference's ``_scores_expr`` / ``_metered_expr``:

* ``predict`` and ``metering="off"`` serve through ``fused_impact``
  (``fused_impact_packed`` under ``packing="2bit"``);
* ``metering="fused"`` bills from ``fused_impact_metered``'s in-kernel
  meters in the same single pass (``fused_impact_packed_metered``, whose
  meters bill the quantized currents, under ``packing="2bit"``);
* ``metering="staged"`` (the default, as in the reference) runs the
  per-shard ``impact_clause_bits`` / ``impact_class_scores``
  compositions over ``crossbar_mvm`` (on the dequantized codes under
  ``packing="2bit"``);
* ``ta_feedback`` (the online trainer's update primitive) runs the
  backend's ``ta_feedback``.

Invalid lanes predict the sentinel -1 and bill exactly 0.

The session also prices and audits what it serves, launching nothing of
its own and preparing nothing: ``cost_analysis(entry, batch)`` sums the
work of the primitives the entry is routed to (``kernels.work``: flops,
bytes, the ``"cuda"`` launches and their bound on an H100), which
``impact.costmodel`` calibrates; ``ir_text(entry, batch)`` is the entry's
op trace, one line for each primitive named by the kernel it launches on
``"cuda"`` and one for each aten op around them, recorded once on zero
inputs of the entry's shapes; ``audit()`` runs ``analysis.ir_audit`` over
those traces, the kernels' working sets (``RuntimeSpec.smem_budget_bytes``)
and, on a card, the compiled kernels.

Co-residency (``RuntimeSpec(coresident=plan)``, ``build_coresident``):
several small single-tile systems packed block-diagonally onto one grid,
served by one session whose entries take a per-lane ``model_ids`` (B,)
tensor selecting each lane's tenant.  The sweeps run the backend's
co-resident primitives, which gate each lane's fired bits to its own
clause-column span before the class stage; predictions are tenant-local
(the argmax over the lane's own class span, rebased to it), and the
per-lane meters are tenant-pure.

A session holds the system's weight-side operands on its device: the
clause currents, or under ``packing="2bit"`` (and on the ``"cuda-packed"``
backend, whatever the spec's ``packing``) their 2-bit packed operand
(``kernels.packing``, packed on the session's device) in their place.
The reference's session re-reads the system's arrays on every call; this
one reads them at construction and again on ``refresh_operands()``,
which ``train.OnlineTrainer`` calls on every session of the system after
each write, so a packed session is re-packed after each write.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels import backends, packing, ref, work
from ..kernels.crossbar_mvm import sm_count
from . import energy as energy_mod
from .energy import EnergyReport
from .yflash import I_CSA_THRESHOLD, T_READ, V_READ

METERING_MODES = ("off", "staged", "fused")
PRECISIONS = ("float32",)
PACKINGS = ("none", "2bit")

#: Canonical literal dtype of every session entry: callers may pass bool /
#: int / float {0,1} literals; the session casts once before the kernels.
LITERAL_DTYPE = torch.int8


@dataclasses.dataclass(frozen=True)
class TenantSpan:
    """Half-open block spans of one resident tenant inside a co-resident
    combined grid: literal rows ``[lit_lo, lit_hi)``, clause columns
    ``[col_lo, col_hi)``, class columns ``[cls_lo, cls_hi)``.  Made by
    ``build_coresident``: the spans are the block-diagonal placement, and
    every cell off the blocks is 0 A."""
    lit_lo: int
    lit_hi: int
    col_lo: int
    col_hi: int
    cls_lo: int
    cls_hi: int

    def __post_init__(self):
        for lo, hi, what in ((self.lit_lo, self.lit_hi, "literal"),
                             (self.col_lo, self.col_hi, "clause"),
                             (self.cls_lo, self.cls_hi, "class")):
            if not 0 <= lo < hi:
                raise ValueError(f"tenant {what} span [{lo}, {hi}) is "
                                 f"empty or negative")


@dataclasses.dataclass(frozen=True)
class CoResidentPlan:
    """Hashable placement of T tenants on one shared crossbar grid:
    ordered, non-overlapping ``TenantSpan`` blocks.  Tenant t's model id
    is its index here; a co-resident session's entries take a per-lane
    ``model_ids`` (B,) operand selecting each lane's tenant.  A frozen
    ``RuntimeSpec`` carries the plan, so the session cache works
    unchanged."""
    spans: tuple[TenantSpan, ...]

    def __post_init__(self):
        object.__setattr__(self, "spans", tuple(self.spans))
        if not self.spans:
            raise ValueError("a CoResidentPlan needs at least one tenant")
        for a, b in zip(self.spans, self.spans[1:]):
            if (b.lit_lo < a.lit_hi or b.col_lo < a.col_hi
                    or b.cls_lo < a.cls_hi):
                raise ValueError(
                    "tenant spans must be ordered and non-overlapping "
                    f"(got {a} then {b})")

    @property
    def n_tenants(self) -> int:
        return len(self.spans)

    @property
    def clause_spans(self) -> tuple[tuple[int, int], ...]:
        return tuple((s.col_lo, s.col_hi) for s in self.spans)

    @property
    def class_spans(self) -> tuple[tuple[int, int], ...]:
        return tuple((s.cls_lo, s.cls_hi) for s in self.spans)

    @property
    def literal_spans(self) -> tuple[tuple[int, int], ...]:
        return tuple((s.lit_lo, s.lit_hi) for s in self.spans)

    def validate_against(self, system) -> None:
        last = self.spans[-1]
        if (last.lit_hi > system.n_literals
                or last.col_hi > system.n_clauses
                or last.cls_hi > system.n_classes):
            raise ValueError(
                f"co-resident plan {last} exceeds the combined grid "
                f"(K={system.n_literals}, n={system.n_clauses}, "
                f"M={system.n_classes}) — compile the plan against the "
                f"system build_coresident returned it with")


@dataclasses.dataclass(frozen=True)
class RuntimeSpec:
    """Declarative, hashable description of ONE inference runtime.

    ``backend`` is a registry key (``"cuda"`` kernels or ``"torch"`` plain
    versions); ``metering`` is ``"off"`` / ``"staged"`` / ``"fused"``;
    ``capacity`` is the serving slot-table shape, prepared at session
    build, and ``batch_sizes`` extra ``predict`` shapes to prepare;
    ``device`` is where the session runs (default ``cuda``);
    ``packing`` is ``"none"`` (f32 clause currents) or ``"2bit"`` (the
    compressed datapath: the clause operand packed once per session).

    ``coresident`` (a ``CoResidentPlan`` from ``build_coresident``)
    compiles the multi-tenant datapath: every entry takes a per-lane
    ``model_ids`` operand, predictions are tenant-local and the per-lane
    meters tenant-pure.  It composes with ``packing="2bit"``.  A
    ``topology`` with a mesh is not ported yet and raises
    ``NotImplementedError``.

    ``smem_budget_bytes`` is the shared memory a block of any kernel the
    session launches may use, as the audit prices it
    (``analysis.smem``); None means an H100's 232,448 B.
    """
    backend: str = "cuda"
    metering: str = "staged"
    precision: str = "float32"
    packing: str = "none"
    capacity: int | None = None
    batch_sizes: tuple[int, ...] = ()
    device: str = DEFAULT_DEVICE
    topology: Any = None
    coresident: CoResidentPlan | None = None
    smem_budget_bytes: int | None = None

    def __post_init__(self):
        if self.coresident is not None and not isinstance(self.coresident,
                                                          CoResidentPlan):
            raise TypeError(f"coresident must be a CoResidentPlan (from "
                            f"build_coresident), got {self.coresident!r}")
        if self.topology is not None:
            raise NotImplementedError(
                "topology= (a device mesh) is not ported yet (ROADMAP "
                "Queue 1, item 13: multiple devices)")
        if self.metering not in METERING_MODES:
            raise ValueError(f"metering must be one of {METERING_MODES}, "
                             f"got {self.metering!r}")
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, "
                             f"got {self.precision!r}")
        if self.packing not in PACKINGS:
            raise ValueError(f"packing must be one of {PACKINGS}, "
                             f"got {self.packing!r}")
        if self.capacity is not None and self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if self.smem_budget_bytes is not None and self.smem_budget_bytes < 1:
            raise ValueError(f"smem_budget_bytes must be >= 1, "
                             f"got {self.smem_budget_bytes}")
        object.__setattr__(self, "batch_sizes",
                           tuple(int(b) for b in self.batch_sizes))
        if any(b < 1 for b in self.batch_sizes):
            raise ValueError(f"batch_sizes must be >= 1, "
                             f"got {self.batch_sizes}")
        object.__setattr__(self, "device", str(torch.device(self.device)))


@dataclasses.dataclass(frozen=True)
class InferenceResult:
    """Unified result of every session entry point: ``predictions``
    always (sentinel -1 on invalid lanes); ``scores`` on ``predict``;
    ``report`` on ``infer_with_report``; per-lane energies (J) on
    ``infer_step``."""
    predictions: torch.Tensor
    scores: torch.Tensor | None = None
    report: EnergyReport | None = None
    e_clause_lanes: torch.Tensor | None = None
    e_class_lanes: torch.Tensor | None = None


class InferenceSession:
    """Compiled runtime for one ``(IMPACTSystem, RuntimeSpec)``; built by
    ``IMPACTSystem.compile(spec)``."""

    _ENTRIES = ("predict", "infer_step", "infer_with_report", "ta_feedback")

    def __init__(self, system, spec: RuntimeSpec):
        self.spec = spec
        self.system = system
        self.backend = backends.get_backend(spec.backend)
        self.device = resolve_device(spec.device)
        # Co-residency: the plan is validated against the combined grid
        # once, and its span tables become small constants on the device
        # that the per-lane model ids index.
        self.coresident = spec.coresident
        if self.coresident is not None:
            self.coresident.validate_against(system)
            self._clause_spans = torch.tensor(
                self.coresident.clause_spans, dtype=torch.int32,
                device=self.device)
            self._class_spans = torch.tensor(
                self.coresident.class_spans, dtype=torch.int32,
                device=self.device)
        self.refresh_operands()
        self._exes: dict[tuple[str, int], Callable] = {}
        self._irs: dict[tuple[str, int], str] = {}
        self._traces: collections.Counter = collections.Counter()
        # The serving sweep and any declared predict shapes are prepared
        # before the first request arrives.
        if spec.capacity is not None:
            self._exe("infer_step", spec.capacity)
        for b in spec.batch_sizes:
            self._exe("predict", b)

    # -- properties ---------------------------------------------------------
    @property
    def capacity(self) -> int | None:
        return self.spec.capacity

    @property
    def packed(self) -> bool:
        """Whether the session serves the 2-bit packed clause operand:
        under ``packing="2bit"``, and always on ``"cuda-packed"``, which
        would otherwise pack the f32 operand again on every sweep."""
        return self.spec.packing == "2bit" or self.backend.serves_packed

    @property
    def meters_energy(self) -> bool:
        return self.spec.metering != "off"

    @property
    def trace_count(self) -> int:
        """Number of prepared ``(entry, batch)`` entries; frozen once the
        serving shapes are warm."""
        return int(sum(self._traces.values()))

    def compiled_shapes(self, entry: str | None = None) -> list[tuple]:
        return sorted(k for k in self._exes
                      if entry is None or k[0] == entry)

    def is_compiled(self, entry: str, batch: int) -> bool:
        return (entry, batch) in self._exes

    def warm(self, batch: int, entry: str = "infer_step") -> None:
        """Ensure the ``(entry, batch)`` entry is prepared (nothing runs)."""
        self._exe(entry, batch)

    # -- cost and audit -----------------------------------------------------
    def route(self, entry: str) -> str:
        """The primitives ``entry`` runs: ``"fused"`` or ``"fused_metered"``
        (on the packed operand when ``packed``), ``"staged"`` (the
        per-shard ``crossbar_mvm`` pair; every co-resident entry) or
        ``"ta_feedback"``.  Raises for an entry this session does not
        serve, as the entry itself would."""
        if entry not in self._ENTRIES:
            raise ValueError(f"unknown entry point {entry!r}")
        if entry == "ta_feedback":
            return "ta_feedback"
        if entry == "infer_with_report" and not self.meters_energy:
            raise RuntimeError("this session was compiled with "
                               "metering='off': it has no infer_with_report")
        metered = entry != "predict" and self.meters_energy
        if self.coresident is not None or (metered and
                                           self.spec.metering == "staged"):
            return "staged"
        # "cuda-metered" serves every fused call through the metered kernel.
        if metered or self.backend.name == "cuda-metered":
            return "fused_metered"
        return "fused"

    @property
    def sm_count(self) -> int:
        """SMs of the session's card, or of an H100 (``work.H100_SMS``)
        for a session on the CPU: the count the launch plans are priced
        for."""
        if self.device.type == "cuda":
            return sm_count(self.device.index or 0)
        return work.H100_SMS

    def mvm_calls(self) -> list[tuple[int, int]]:
        """(K, N) of each ``crossbar_mvm`` call of one staged sweep: one a
        row shard over its driven rows, then one a class shard over its
        rows that hold a clause column (``Backend.impact_clause_bits`` /
        ``impact_class_scores``)."""
        sys_ = self.system
        R, C, tr, tc = sys_.clause_i.shape
        S, sr, M = sys_.class_i.shape
        calls = [(k, C * tc) for k in work.live_rows(sys_.n_literals, R, tr)]
        return calls + [(max(0, min(sr, C * tc - s * sr)), M)
                        for s in range(S)]

    def _needed(self) -> tuple[int, int]:
        """``work.needed_columns`` on this session's operands (read from
        the card once per ``refresh_operands``)."""
        if self._needed_cols is None:
            sys_ = self.system
            R, C, tr, tc = sys_.clause_i.shape
            rows = work.live_rows(sys_.n_literals, R, tr)
            drawing = torch.zeros((C, tc), dtype=torch.bool,
                                  device=self.device)
            for r, k in enumerate(rows):
                if self._packed is not None:
                    codes = self._packed.bits[r, :, :-(-k // 4)]
                else:
                    codes = self._clause_i[r, :, :k]
                drawing |= codes.ne(0).any(dim=1)
            self._needed_cols = work.needed_columns(self._nonempty,
                                                    drawing.reshape(-1))
        return self._needed_cols

    def work_items(self, entry: str, batch: int) -> list[work.Item]:
        """The work of one ``(entry, batch)`` call, one item a primitive
        it is routed to (the staged path's dequantize of a packed operand
        included), counted from shapes by ``kernels.work`` over the
        columns this system's data needs.  Nothing runs and nothing is
        prepared."""
        sys_ = self.system
        route = self.route(entry)
        B, K = batch, sys_.n_literals
        if route == "ta_feedback":
            n = sys_.n_clauses
            return [work.Item("ta_feedback_i32",
                              *work.ta_feedback(B, K, n),
                              work.launches_one(K, n), work.PEAK_INT8_OPS)]
        R, C, tr, tc = sys_.clause_i.shape
        S, sr, M = sys_.class_i.shape
        if route == "staged":
            items = []
            if self._packed is not None:
                items.append(work.Item("dequant_clause",
                                       *work.dequant_clause(R, C, tr, tc),
                                       0))
            sms = self.sm_count
            items += [work.Item("crossbar_mvm_f32", *work.crossbar_mvm(B, k, n),
                                work.launches_mvm(B, k, n, sms))
                      for k, n in self.mvm_calls()]
            return items
        metered = route == "fused_metered"
        packed = self._packed is not None
        name = ("fused_impact" + ("_packed" if packed else "")
                + ("_metered" if metered else "") + "_f32")
        return [work.Item(name, *work.fused_impact(
            B, K, R, tr, C * tc, S * sr, M, metered=metered, packed=packed,
            needed=self._needed()), work.launches_fused(B, C * tc))]

    def cost_analysis(self, entry: str, batch: int) -> dict[str, float]:
        """The work of the ``(entry, batch)`` call, summed over ``work_items``:
        ``{"flops", "bytes_accessed", "launches", "bound_s"}`` floats,
        ``launches`` the device launches of the port's kernels on
        ``"cuda"`` and ``bound_s`` the least time an H100 could take for
        them (each primitive's larger of operations over its peak and
        bytes over the memory rate).  Launches nothing and prepares
        nothing: ``trace_count`` does not move."""
        items = self.work_items(entry, batch)
        return dict(flops=float(sum(i.flops for i in items)),
                    bytes_accessed=float(sum(i.bytes for i in items)),
                    launches=float(sum(i.launches for i in items)),
                    bound_s=float(sum(i.bound_s for i in items)))

    def zero_inputs(self, entry: str, batch: int) -> tuple[torch.Tensor, ...]:
        """Zero tensors of the ``(entry, batch)`` entry's own operand
        shapes and dtypes on the session's device: the inputs ``ir_text``
        runs the entry on."""
        sys_ = self.system
        z = lambda shape, dtype: torch.zeros(shape, dtype=dtype,
                                             device=self.device)
        K, n = sys_.n_literals, sys_.n_clauses
        if entry == "ta_feedback":
            return (z((batch, K), LITERAL_DTYPE),
                    *(z((batch, n), torch.bool) for _ in range(3)),
                    z((K, n), torch.int32), z((K, n), torch.int32),
                    z((K, n), torch.bool))
        args = (z((batch, K), LITERAL_DTYPE),)
        if entry != "predict":
            args += (z((batch,), torch.bool),)
        if self.coresident is not None:
            args += (z((batch,), torch.int32),)
        return args

    def entry_fn(self, entry: str) -> Callable:
        """The function that serves ``entry`` on this session's routing,
        taking the entry's tensor operands on the session's device (as
        ``zero_inputs`` makes them); prepares nothing."""
        self.route(entry)
        return getattr(self, f"_{entry}_fn")

    def ir_text(self, entry: str, batch: int) -> str:
        """The ``(entry, batch)`` entry's op trace, the counterpart of the
        reference's StableHLO text: one line for each primitive it is
        routed to, named by the kernel that primitive launches on
        ``"cuda"``, and one for each aten op outside them, with dtypes
        and shapes (``analysis.ir_audit.record_ops``).  Recorded the first
        time it is asked for, by running the entry once on
        ``zero_inputs``; prepares nothing."""
        key = (entry, batch)
        if key not in self._irs:
            from ..analysis import ir_audit
            self._irs[key] = ir_audit.record_ops(
                self.entry_fn(entry), self.zero_inputs(entry, batch))
        return self._irs[key]

    def audit(self, entry: str | None = None, batch: int | None = None, *,
              baselines=None):
        """Static audit of what this session serves
        (``analysis.ir_audit.audit_session``): the op traces' precision
        ladder and host isolation, the kernels' shared memory against
        ``spec.smem_budget_bytes``, fingerprints (diffed against
        ``baselines`` when given), and on a card the compiled kernels'
        occupancy and SASS.  Audits every prepared ``(entry, batch)``, or
        the one pair given, which it does not prepare."""
        from ..analysis import ir_audit
        return ir_audit.audit_session(self, entry, batch,
                                      baselines=baselines)

    def refresh_operands(self) -> None:
        """(Re-)read the system's clause currents (packed, when the session
        is ``packed``), nonempty mask and class currents onto the
        session's device.  The session's tensors are re-pointed at new
        ones, not written in place, so a caller still holding the old
        tensors keeps the old values."""
        sys_ = self.system
        clause_i = sys_.clause_i.to(self.device).contiguous()
        if self.packed:
            self._clause_i = None
            self._packed = self.backend.pack_clause_operand(clause_i)
        else:
            self._clause_i = clause_i
            self._packed = None
        self._nonempty = sys_._nonempty_eff().to(self.device)
        self._class_i = sys_.class_i.to(self.device).contiguous()
        self._needed_cols: tuple[int, int] | None = None

    def _operands(self) -> tuple[torch.Tensor, ...]:
        """The weight-side operands a sweep reads: ``(clause_i, nonempty,
        class_i)``, or ``(bits, levels, nonempty, class_i)`` under
        ``packing="2bit"``."""
        if self._packed is not None:
            return (*self._packed, self._nonempty, self._class_i)
        return self._clause_i, self._nonempty, self._class_i

    def input_bytes(self, entry: str, batch: int) -> int:
        """Bytes of the ``(entry, batch)`` entry's input tensors per sweep:
        the literals, the valid mask (all but ``predict``), the (B,)
        int32 model ids of a co-resident session and the weight-side
        operands, as the reference counts them."""
        n = batch * self.system.n_literals * LITERAL_DTYPE.itemsize
        if entry != "predict":
            n += batch * torch.bool.itemsize
        if self.coresident is not None:
            n += batch * torch.int32.itemsize
        for op in self._operands():
            n += op.numel() * op.element_size()
        return int(n)

    # -- entry points -------------------------------------------------------
    def _model_ids(self, model_ids, batch: int) -> tuple[torch.Tensor, ...]:
        """The per-lane tenant selector as the entry's extra operand: ``()``
        on a single-tenant session (which refuses one), a (B,) int32
        tensor on the session's device on a co-resident one (which needs
        one, each id naming a tenant of the plan)."""
        if self.coresident is None:
            if model_ids is not None:
                raise ValueError(
                    "model_ids= only applies to a co-resident session "
                    "(RuntimeSpec(coresident=...))")
            return ()
        if model_ids is None:
            raise ValueError(
                "a co-resident session needs model_ids (B,) int32 — "
                "which tenant does each lane belong to?")
        mids = torch.as_tensor(model_ids)
        if mids.shape != (batch,):
            raise ValueError(f"model_ids shape {tuple(mids.shape)} does not "
                             f"match the batch ({batch},)")
        if mids.dtype.is_floating_point or mids.dtype == torch.bool:
            raise ValueError(f"model_ids must be integers, got {mids.dtype}")
        # Checked here: an index out of the span table would be a device
        # fault in the gather on a card.
        if batch and (int(mids.min()) < 0
                      or int(mids.max()) >= self.coresident.n_tenants):
            raise ValueError(
                f"model_ids must lie in [0, {self.coresident.n_tenants}) "
                f"(the plan's tenants), got [{int(mids.min())}, "
                f"{int(mids.max())}]")
        return (mids.to(device=self.device, dtype=torch.int32),)

    def predict(self, literals, model_ids=None) -> InferenceResult:
        """Fused crossbar -> CSA -> class-sum scores + argmax.  On a
        co-resident session ``model_ids`` (B,) selects each lane's tenant:
        predictions are tenant-local class indices and ``scores`` the
        combined (B, M_total) currents, zero outside each lane's own class
        span."""
        lits = self._lits(literals)
        mids = self._model_ids(model_ids, lits.shape[0])
        preds, scores = self._exe("predict", lits.shape[0])(lits, *mids)
        return InferenceResult(predictions=preds, scores=scores)

    def infer_step(self, literals, valid, model_ids=None) -> InferenceResult:
        """One scheduler sweep over a fixed-capacity slot buffer: invalid
        lanes predict -1 and bill exactly zero; per-lane energies are
        zeros under ``metering="off"``.  On a co-resident session
        ``model_ids`` selects each lane's tenant."""
        lits = self._lits(literals)
        v = self._valid(valid, lits.shape[0])
        mids = self._model_ids(model_ids, lits.shape[0])
        preds, e_cl, e_cs = self._exe("infer_step", lits.shape[0])(lits, v,
                                                                   *mids)
        return InferenceResult(predictions=preds, e_clause_lanes=e_cl,
                               e_class_lanes=e_cs)

    def infer_with_report(self, literals, valid=None,
                          model_ids=None) -> InferenceResult:
        """Metered inference with the paper's batch-level ``EnergyReport``
        (one fused pass under ``"fused"``, the staged per-shard path under
        ``"staged"``).  Padding lanes (``valid`` False) are excluded from
        the accounting and predict -1.  On a co-resident session
        ``model_ids`` selects each lane's tenant."""
        if not self.meters_energy:
            raise RuntimeError(
                "this session was compiled with metering='off' — "
                "infer_with_report needs RuntimeSpec(metering='fused') "
                "(single-pass, serving speed) or 'staged' (the oracle)")
        lits = self._lits(literals)
        B = lits.shape[0]
        v = self._valid(valid, B)
        mids = self._model_ids(model_ids, B)
        preds, i_cl_sum, i_cs_sum = self._exe("infer_with_report", B)(
            lits, v, *mids)
        sys_ = self.system
        e_clause = float(V_READ * i_cl_sum * T_READ)
        e_class = float(V_READ * i_cs_sum * T_READ)
        n_dp = int(v.sum())
        ops_xp = n_dp * (sys_.n_literals * sys_.n_clauses
                         + sys_.n_clauses * sys_.n_classes)
        report = EnergyReport(
            read_energy_j=e_clause + e_class,
            clause_energy_j=e_clause, class_energy_j=e_class,
            program_energy_j=sys_.encode_stats["program_energy_j"],
            erase_energy_j=sys_.encode_stats["erase_energy_j"],
            latency_s=sys_._grid_latency(), ops_crosspoint=ops_xp,
            datapoints=n_dp, area_mm2=sum(sys_.area_mm2().values()))
        return InferenceResult(predictions=preds, report=report)

    def ta_feedback(self, lit2, fired2, sel, match, hi, lo,
                    include) -> torch.Tensor:
        """CoTM Type I/II TA feedback deltas -> (K, n) int32, routed through
        the session's backend like every serving entry.

        ``lit2`` (2B, K) doubled literal rows; ``fired2`` / ``sel`` /
        ``match`` (2B, n) feedback masks; ``hi`` / ``lo`` (K, n) int32
        draws; ``include`` (K, n) current TA actions.  The entry's batch
        is the doubled row count 2B.
        """
        dev = self.device
        lit2 = torch.as_tensor(lit2, device=dev).to(LITERAL_DTYPE)
        fn = self._exe("ta_feedback", lit2.shape[0])
        b = lambda x: torch.as_tensor(x, device=dev).to(torch.bool)
        i32 = lambda x: torch.as_tensor(x, device=dev).to(torch.int32)
        return fn(lit2, b(fired2), b(sel), b(match), i32(hi), i32(lo),
                  b(include))

    # -- plumbing -----------------------------------------------------------
    def _lits(self, literals) -> torch.Tensor:
        return torch.as_tensor(literals, device=self.device).to(
            LITERAL_DTYPE)

    def _valid(self, valid, batch: int) -> torch.Tensor:
        if valid is None:
            return torch.ones((batch,), dtype=torch.bool, device=self.device)
        v = torch.as_tensor(valid, device=self.device).to(torch.bool)
        if v.shape != (batch,):
            raise ValueError(f"valid shape {tuple(v.shape)} does not match "
                             f"the batch ({batch},)")
        return v

    def _exe(self, entry: str, batch: int) -> Callable:
        key = (entry, batch)
        fn = self._exes.get(key)
        if fn is None:
            if entry not in self._ENTRIES:
                raise ValueError(f"unknown entry point {entry!r}")
            fn = getattr(self, f"_{entry}_fn")
            self._exes[key] = fn
            self._traces[entry] += 1
        return fn

    def _scores_expr(self, literals: torch.Tensor) -> torch.Tensor:
        if self._packed is not None:
            return self.backend.fused_impact_packed(
                literals, self._packed, self._nonempty, self._class_i,
                thresh=I_CSA_THRESHOLD, tr=self.system.clause_i.shape[2])
        return self.backend.fused_impact(
            literals, self._clause_i, self._nonempty, self._class_i,
            thresh=I_CSA_THRESHOLD)

    def _metered_expr(self, literals: torch.Tensor, valid: torch.Tensor):
        """Metered core -> (scores (B, m), per-lane summed clause currents
        (B,), per-lane summed class currents (B,)), zero on invalid lanes:
        the fused meters, or the staged per-shard oracle.  A packed
        session meters the quantized currents, the ones its cells draw."""
        tr = self.system.clause_i.shape[2]
        if self.spec.metering == "fused":
            if self._packed is not None:
                scores, i_cl, i_cs = self.backend.fused_impact_packed_metered(
                    literals, self._packed, self._nonempty, self._class_i,
                    thresh=I_CSA_THRESHOLD, tr=tr)
            else:
                scores, i_cl, i_cs = self.backend.fused_impact_metered(
                    literals, self._clause_i, self._nonempty, self._class_i,
                    thresh=I_CSA_THRESHOLD)
            # Meters are per-lane, so masking after the fused pass is exact.
            v = valid.to(scores.dtype)
            return scores, i_cl * v, i_cs * v
        clause_i = (self._clause_i if self._packed is None else
                    packing.dequant_clause(*self._packed, tr))
        fired, i_clause = self.backend.impact_clause_bits(
            literals, clause_i, self._nonempty, thresh=I_CSA_THRESHOLD)
        fired = fired & valid[:, None]
        i_clause = i_clause * valid[:, None, None, None]
        scores, i_class = self.backend.impact_class_scores(fired,
                                                           self._class_i)
        return (scores, i_clause.sum(dim=(1, 2, 3)),
                i_class.sum(dim=(1, 2)))

    # -- co-resident expressions --------------------------------------------
    def _co_pred(self, scores: torch.Tensor,
                 model_ids: torch.Tensor) -> torch.Tensor:
        """Tenant-local argmax: each lane's argmax over its own class
        span, rebased to the span, so a co-resident lane predicts what its
        tenant's standalone session would."""
        spans = self._class_spans[model_ids.long()].long()     # (B, 2)
        col = torch.arange(scores.shape[1], device=scores.device)[None, :]
        mask = (col >= spans[:, :1]) & (col < spans[:, 1:])
        masked = torch.where(mask, scores, -torch.inf)
        return torch.argmax(masked, dim=-1) - spans[:, 0]

    def _co_scores_expr(self, literals: torch.Tensor,
                        model_ids: torch.Tensor) -> torch.Tensor:
        """Co-resident twin of ``_scores_expr``: the backend's co-resident
        primitives (packed or not), which gate fired bits to each lane's
        own clause-column span before the class stage."""
        if self._packed is not None:
            return self.backend.fused_impact_coresident_packed(
                literals, self._packed, self._nonempty, self._class_i,
                model_ids, self._clause_spans, thresh=I_CSA_THRESHOLD,
                tr=self.system.clause_i.shape[2])
        return self.backend.fused_impact_coresident(
            literals, self._clause_i, self._nonempty, self._class_i,
            model_ids, self._clause_spans, thresh=I_CSA_THRESHOLD)

    def _co_metered_expr(self, literals: torch.Tensor, valid: torch.Tensor,
                         model_ids: torch.Tensor):
        """Metered co-resident core, routed as ``_metered_expr``: under
        ``"fused"`` the backend's co-resident metered primitive, invalid
        lanes masked after (exact: the meters are per-lane); under
        ``"staged"`` the per-shard pair with the lane mask and the valid
        mask on the fired bits before the class drive.  Valid lanes see
        the same composition either way."""
        tr = self.system.clause_i.shape[2]
        if self.spec.metering == "fused":
            if self._packed is not None:
                scores, i_cl, i_cs = (
                    self.backend.fused_impact_coresident_packed_metered(
                        literals, self._packed, self._nonempty,
                        self._class_i, model_ids, self._clause_spans,
                        thresh=I_CSA_THRESHOLD, tr=tr))
            else:
                scores, i_cl, i_cs = (
                    self.backend.fused_impact_coresident_metered(
                        literals, self._clause_i, self._nonempty,
                        self._class_i, model_ids, self._clause_spans,
                        thresh=I_CSA_THRESHOLD))
            v = valid.to(scores.dtype)
            return scores, i_cl * v, i_cs * v
        clause_i = (self._clause_i if self._packed is None else
                    packing.dequant_clause(*self._packed, tr))
        fired, i_clause = self.backend.impact_clause_bits(
            literals, clause_i, self._nonempty, thresh=I_CSA_THRESHOLD)
        # The CSA gating step of co-residency, then the valid lanes.
        fired = (fired & ref.coresident_lane_mask(
            model_ids, self._clause_spans, self.system.n_clauses)
            & valid[:, None])
        i_clause = i_clause * valid[:, None, None, None]
        scores, i_class = self.backend.impact_class_scores(fired,
                                                           self._class_i)
        return (scores, i_clause.sum(dim=(1, 2, 3)),
                i_class.sum(dim=(1, 2)))

    def _ta_feedback_fn(self, lit2, fired2, sel, match, hi, lo, include):
        return self.backend.ta_feedback(lit2, fired2, sel, match, hi, lo,
                                        include)

    def _predict_fn(self, literals, *model_ids):
        if self.coresident is not None:
            scores = self._co_scores_expr(literals, *model_ids)
            return self._co_pred(scores, *model_ids), scores
        scores = self._scores_expr(literals)
        return torch.argmax(scores, dim=-1), scores

    def _infer_step_fn(self, literals, valid, *model_ids):
        co = self.coresident is not None
        if not self.meters_energy:
            scores = (self._co_scores_expr(literals, *model_ids) if co
                      else self._scores_expr(literals))
            zeros = torch.zeros((literals.shape[0],), dtype=torch.float32,
                                device=literals.device)
            e_cl = e_cs = zeros
        else:
            scores, i_cl, i_cs = (
                self._co_metered_expr(literals, valid, *model_ids) if co
                else self._metered_expr(literals, valid))
            e_cl, e_cs = energy_mod.per_lane_read_energy(i_cl, i_cs)
        preds = (self._co_pred(scores, *model_ids) if co
                 else torch.argmax(scores, dim=-1))
        return torch.where(valid, preds, -1), e_cl, e_cs

    def _infer_with_report_fn(self, literals, valid, *model_ids):
        if self.coresident is not None:
            scores, i_cl_lane, i_cs_lane = self._co_metered_expr(
                literals, valid, *model_ids)
            preds = self._co_pred(scores, *model_ids)
        else:
            scores, i_cl_lane, i_cs_lane = self._metered_expr(literals,
                                                              valid)
            preds = torch.argmax(scores, dim=-1)
        # Sentinel invalid lanes like infer_step: the staged and fused
        # lowerings see different scores on an excluded lane.
        return (torch.where(valid, preds, -1), i_cl_lane.sum(),
                i_cs_lane.sum())

    def __repr__(self) -> str:
        return (f"InferenceSession(backend={self.spec.backend!r}, "
                f"device={self.spec.device!r}, "
                f"metering={self.spec.metering!r}, "
                f"packing={self.spec.packing!r}, "
                f"capacity={self.spec.capacity}, "
                f"compiled={self.compiled_shapes()})")


def build_coresident(systems) -> tuple[Any, CoResidentPlan]:
    """Pack several small single-tile systems block-diagonally onto one
    shared crossbar grid -> ``(combined IMPACTSystem, CoResidentPlan)``,
    on the members' device.

    Tenant t's clause grid occupies literal rows ``[lit_lo, lit_hi)`` x
    clause columns ``[col_lo, col_hi)`` and its class grid clause rows
    ``[col_lo, col_hi)`` x class columns ``[cls_lo, cls_hi)``.  Every cell
    off the blocks holds exactly 0 S / 0 A (no device), so cross-tenant
    current leakage is exactly zero.  Only each member's real ``[:K, :n]``
    and ``[:n, :M]`` regions are copied (its tile padding is dropped),
    which keeps scores and argmax equal to its standalone session's.

    Members must be single-tile (R = C = S = 1): a model big enough to
    shard owns the fabric.  The combined grid must fit one tile of the
    first member's ``IMPACTConfig``.  Compile with
    ``combined.compile(RuntimeSpec(coresident=plan, ...))``; tenant t's
    lanes pass ``model_ids == t``.
    """
    systems = list(systems)
    if not systems:
        raise ValueError("build_coresident needs at least one system")
    from .pipeline import IMPACTSystem   # pipeline imports this module

    for i, s in enumerate(systems):
        R, C = s.clause_i.shape[0], s.clause_i.shape[1]
        S = s.class_i.shape[0]
        if (R, C, S) != (1, 1, 1):
            raise ValueError(
                f"co-residency packs single-tile systems; member {i} has "
                f"a (R={R}, C={C}, S={S}) shard grid — a model that "
                f"large should own the fabric (shard it) instead of "
                f"co-residing")
    dev = systems[0].device
    if any(s.device != dev for s in systems):
        raise ValueError(f"co-resident members must share one device, got "
                         f"{sorted({str(s.device) for s in systems})}")
    K_tot = sum(s.n_literals for s in systems)
    n_tot = sum(s.n_clauses for s in systems)
    M_tot = sum(s.n_classes for s in systems)
    cfg = systems[0].cfg
    if (K_tot > cfg.max_tile_rows or n_tot > cfg.max_tile_cols
            or n_tot > cfg.max_class_rows):
        raise ValueError(
            f"combined co-resident grid (K={K_tot}, n={n_tot}) does not "
            f"fit one tile (max_tile_rows={cfg.max_tile_rows}, "
            f"max_tile_cols={cfg.max_tile_cols}, "
            f"max_class_rows={cfg.max_class_rows}) — fewer residents per "
            f"fabric, or bigger tiles")

    f32 = dict(dtype=torch.float32, device=dev)
    clause_g = torch.zeros((1, 1, K_tot, n_tot), **f32)
    clause_i = torch.zeros((1, 1, K_tot, n_tot), **f32)
    nonempty = torch.zeros((n_tot,), dtype=torch.bool, device=dev)
    class_g = torch.zeros((1, n_tot, M_tot), **f32)
    class_i = torch.zeros((1, n_tot, M_tot), **f32)
    spans = []
    k0 = c0 = m0 = 0
    prog = erase = 0.0
    for s in systems:
        K, n, M = s.n_literals, s.n_clauses, s.n_classes
        clause_g[0, 0, k0:k0 + K, c0:c0 + n] = s.clause_g[0, 0, :K, :n]
        clause_i[0, 0, k0:k0 + K, c0:c0 + n] = s.clause_i[0, 0, :K, :n]
        nonempty[c0:c0 + n] = s.nonempty[:n]
        class_g[0, c0:c0 + n, m0:m0 + M] = s.class_g[0, :n, :M]
        class_i[0, c0:c0 + n, m0:m0 + M] = s.class_i[0, :n, :M]
        spans.append(TenantSpan(lit_lo=k0, lit_hi=k0 + K,
                                col_lo=c0, col_hi=c0 + n,
                                cls_lo=m0, cls_hi=m0 + M))
        k0, c0, m0 = k0 + K, c0 + n, m0 + M
        prog += float(s.encode_stats.get("program_energy_j", 0.0))
        erase += float(s.encode_stats.get("erase_energy_j", 0.0))
    combined = IMPACTSystem(
        clause_g=clause_g, nonempty=nonempty, class_g=class_g,
        clause_i=clause_i, class_i=class_i, n_literals=K_tot,
        n_clauses=n_tot, n_classes=M_tot, cfg=cfg,
        encode_stats=dict(program_energy_j=prog, erase_energy_j=erase,
                          coresident_members=len(systems)))
    return combined, CoResidentPlan(spans=tuple(spans))

"""Compiled-session runtime: ``RuntimeSpec`` -> ``InferenceSession`` (the
PyTorch port of ``repro.impact.runtime`` for one device, no
co-residency).

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
from ..kernels import backends, packing
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
class RuntimeSpec:
    """Declarative, hashable description of ONE inference runtime.

    ``backend`` is a registry key (``"cuda"`` kernels or ``"torch"`` plain
    versions); ``metering`` is ``"off"`` / ``"staged"`` / ``"fused"``;
    ``capacity`` is the serving slot-table shape, prepared at session
    build, and ``batch_sizes`` extra ``predict`` shapes to prepare;
    ``device`` is where the session runs (default ``cuda``);
    ``packing`` is ``"none"`` (f32 clause currents) or ``"2bit"`` (the
    compressed datapath: the clause operand packed once per session).

    ``coresident`` and a ``topology`` with a mesh are not ported yet and
    raise ``NotImplementedError``.
    """
    backend: str = "cuda"
    metering: str = "staged"
    precision: str = "float32"
    packing: str = "none"
    capacity: int | None = None
    batch_sizes: tuple[int, ...] = ()
    device: str = DEFAULT_DEVICE
    topology: Any = None
    coresident: Any = None

    def __post_init__(self):
        if self.coresident is not None:
            raise NotImplementedError(
                "coresident= is not ported yet (ROADMAP Queue 1, item 10: "
                "co-residency and the multi-tenant zoo)")
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
        self.refresh_operands()
        self._exes: dict[tuple[str, int], Callable] = {}
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

    def _operands(self) -> tuple[torch.Tensor, ...]:
        """The weight-side operands a sweep reads: ``(clause_i, nonempty,
        class_i)``, or ``(bits, levels, nonempty, class_i)`` under
        ``packing="2bit"``."""
        if self._packed is not None:
            return (*self._packed, self._nonempty, self._class_i)
        return self._clause_i, self._nonempty, self._class_i

    def input_bytes(self, entry: str, batch: int) -> int:
        """Bytes of the ``(entry, batch)`` entry's input tensors per sweep:
        the literals, the valid mask (all but ``predict``) and the
        weight-side operands, as the reference counts them."""
        n = batch * self.system.n_literals * LITERAL_DTYPE.itemsize
        if entry != "predict":
            n += batch * torch.bool.itemsize
        for op in self._operands():
            n += op.numel() * op.element_size()
        return int(n)

    # -- entry points -------------------------------------------------------
    def predict(self, literals) -> InferenceResult:
        """Fused crossbar -> CSA -> class-sum scores + argmax."""
        lits = self._lits(literals)
        preds, scores = self._exe("predict", lits.shape[0])(lits)
        return InferenceResult(predictions=preds, scores=scores)

    def infer_step(self, literals, valid) -> InferenceResult:
        """One scheduler sweep over a fixed-capacity slot buffer: invalid
        lanes predict -1 and bill exactly zero; per-lane energies are
        zeros under ``metering="off"``."""
        lits = self._lits(literals)
        v = self._valid(valid, lits.shape[0])
        preds, e_cl, e_cs = self._exe("infer_step", lits.shape[0])(lits, v)
        return InferenceResult(predictions=preds, e_clause_lanes=e_cl,
                               e_class_lanes=e_cs)

    def infer_with_report(self, literals, valid=None) -> InferenceResult:
        """Metered inference with the paper's batch-level ``EnergyReport``
        (one fused pass under ``"fused"``, the staged per-shard path under
        ``"staged"``).  Padding lanes (``valid`` False) are excluded from
        the accounting and predict -1."""
        if not self.meters_energy:
            raise RuntimeError(
                "this session was compiled with metering='off' — "
                "infer_with_report needs RuntimeSpec(metering='fused') "
                "(single-pass, serving speed) or 'staged' (the oracle)")
        lits = self._lits(literals)
        B = lits.shape[0]
        v = self._valid(valid, B)
        preds, i_cl_sum, i_cs_sum = self._exe("infer_with_report", B)(lits, v)
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

    def _ta_feedback_fn(self, lit2, fired2, sel, match, hi, lo, include):
        return self.backend.ta_feedback(lit2, fired2, sel, match, hi, lo,
                                        include)

    def _predict_fn(self, literals):
        scores = self._scores_expr(literals)
        return torch.argmax(scores, dim=-1), scores

    def _infer_step_fn(self, literals, valid):
        if not self.meters_energy:
            scores = self._scores_expr(literals)
            zeros = torch.zeros((literals.shape[0],), dtype=torch.float32,
                                device=literals.device)
            return (torch.where(valid, torch.argmax(scores, dim=-1), -1),
                    zeros, zeros)
        scores, i_cl, i_cs = self._metered_expr(literals, valid)
        e_cl, e_cs = energy_mod.per_lane_read_energy(i_cl, i_cs)
        return (torch.where(valid, torch.argmax(scores, dim=-1), -1),
                e_cl, e_cs)

    def _infer_with_report_fn(self, literals, valid):
        scores, i_cl_lane, i_cs_lane = self._metered_expr(literals, valid)
        # Sentinel invalid lanes like infer_step: the staged and fused
        # lowerings see different scores on an excluded lane.
        return (torch.where(valid, torch.argmax(scores, dim=-1), -1),
                i_cl_lane.sum(), i_cs_lane.sum())

    def __repr__(self) -> str:
        return (f"InferenceSession(backend={self.spec.backend!r}, "
                f"device={self.spec.device!r}, "
                f"metering={self.spec.metering!r}, "
                f"packing={self.spec.packing!r}, "
                f"capacity={self.spec.capacity}, "
                f"compiled={self.compiled_shapes()})")

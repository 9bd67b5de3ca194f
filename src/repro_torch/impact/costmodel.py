"""Calibrated analytic sweep-cost model: predicted against measured sweep
time (the port of ``repro.impact.costmodel``).

``InferenceSession.cost_analysis`` counts, from shapes, the work of the
primitives an entry is routed to (``kernels.work``): flops, bytes, the
device launches of the port's kernels on ``"cuda"`` and the least time an
H100 could take for that work.  A host-time proxy built from those
counts is **calibrated once per session** (one measured warm sweep at a
reference batch) and then *predicts* every other batch; the ratio of
predicted to measured must stay within ``DEFAULT_BAND``, so a shape that
falls off its path (a meter pass run twice, a kernel that stops
launching) shows as a miss on the shape that broke.

**Where this departs from the reference.**  The reference's proxy adds
flops and bytes at unit weight: its CPU interpret mode has no flop:byte
rate to split them.  The card has both a rate and a launch cost, and a
sweep on it is bound by the host and by launches, not by the work: the
device is busy 1-3% of the serving wall (``PERF.md`` §5).  At the
paper's layout a unit-weight proxy grows about 12x from B = 8 to
B = 128 (2·B·1568·500 flops against a 4.19 MB clause operand), while
the measured sweep grows far less, so a model calibrated at B = 8 would
predict B = 128 at several times its time, out of the band.  So ``raw``
prices time on the card instead: each primitive's larger of its
operations over the H100's peak for their type and its bytes over the
memory rate (``cost_analysis``' ``bound_s``), plus the launches times
the cost of one launch.  The calibration then absorbs what the host adds
around them.

Two predictions, kept apart:

* **Host sweep time** (``predict_s``): the calibrated ``raw``.
* **Analog crossbar time** (``analog_latency_s``): the Fig. 14 cycle
  model of the system's (R, C) grid (``IMPACTSystem._grid_latency``),
  the floor the hardware twin puts under every sweep whatever the batch;
  ``predict_s`` is the larger of the two.

The uncalibrated ``raw`` also carries the ordering the gate holds: the
fused metered kernel does at least the unmetered one's work (its meters
read every column that draws current, and write two meters a lane), so
``raw(metered) >= raw(off)`` at every batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any

#: Predicted/measured acceptance band, the reference's: calibration pins
#: the reference batch to 1.0, and the band only has to catch
#: order-of-magnitude breaks.
DEFAULT_BAND = (0.2, 5.0)

#: One empty kernel launch under the CUDA-event timer on an NVIDIA H100
#: 80GB HBM3 at 700 W: 0.0047-0.0050 ms (``chip_smoke.py`` phase 7,
#: PERF.md kernel table).
LAUNCH_S = 4.8e-6


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """One entry's analytic cost at one batch."""
    entry: str
    batch: int
    flops: float
    bytes_accessed: float
    analog_latency_s: float
    launches: float = 0.0
    bound_s: float = 0.0

    @property
    def raw(self) -> float:
        """Uncalibrated cost, in seconds of an H100: the work's bound plus
        ``launches`` x ``LAUNCH_S``.  Positive, so that calibration can
        divide by it."""
        return max(self.bound_s + self.launches * LAUNCH_S, 1e-9)


class SweepCostModel:
    """Analytic cost model for ONE session entry point: ``estimate``
    reads the session's counts, ``calibrate`` fixes seconds per unit of
    ``raw`` from one measured warm sweep, ``predict_s`` prices any batch.
    Sessions of other specs route to other primitives and calibrate
    apart."""

    def __init__(self, session, entry: str = "infer_step"):
        self.session = session
        self.entry = entry
        self._scale: float | None = None
        self._ref: tuple[int, float] | None = None

    def estimate(self, batch: int) -> CostEstimate:
        ca = self.session.cost_analysis(self.entry, batch)
        return CostEstimate(
            entry=self.entry, batch=batch, flops=ca["flops"],
            bytes_accessed=ca["bytes_accessed"],
            analog_latency_s=self.session.system._grid_latency(),
            launches=ca["launches"], bound_s=ca["bound_s"])

    def calibrate(self, batch: int, measured_s: float) -> None:
        """Fix the coefficient: ``measured_s`` is one warm sweep's wall
        time at ``batch``."""
        if measured_s <= 0.0:
            raise ValueError(f"measured_s must be positive, "
                             f"got {measured_s}")
        self._scale = measured_s / self.estimate(batch).raw
        self._ref = (batch, measured_s)

    @property
    def calibration(self) -> dict[str, Any]:
        if self._scale is None:
            raise RuntimeError("cost model is not calibrated — call "
                               "calibrate(batch, measured_s) first")
        return dict(ref_batch=self._ref[0], ref_measured_s=self._ref[1],
                    seconds_per_unit=self._scale)

    def predict_s(self, batch: int) -> float:
        """Predicted sweep wall time: the calibrated host term, floored by
        the Fig. 14 analog crossbar latency."""
        if self._scale is None:
            raise RuntimeError("cost model is not calibrated — call "
                               "calibrate(batch, measured_s) first")
        est = self.estimate(batch)
        return max(est.raw * self._scale, est.analog_latency_s)


def bytes_per_sweep(session, entry: str, batch: int) -> dict[str, float]:
    """One entry's traffic counts: ``flops`` / ``bytes_accessed`` (the
    work of its primitives, ``cost_analysis``) and ``input_bytes`` (its
    operand tensors, ``session.input_bytes``).  They fail apart: a packed
    operand dequantized outside the kernels keeps ``input_bytes`` small
    and grows ``bytes_accessed``."""
    ca = session.cost_analysis(entry, batch)
    return dict(flops=float(ca["flops"]),
                bytes_accessed=float(ca["bytes_accessed"]),
                input_bytes=float(session.input_bytes(entry, batch)))


def _entry_record(model: SweepCostModel, batch: int, measured_s: float,
                  *, is_ref: bool) -> dict[str, Any]:
    est = model.estimate(batch)
    pred = model.predict_s(batch)
    return dict(
        flops=est.flops, bytes_accessed=est.bytes_accessed,
        launches=est.launches, bound_s=est.bound_s,
        analog_latency_s=est.analog_latency_s,
        predicted_s=pred, measured_s=measured_s,
        ratio_pred_over_meas=pred / measured_s,
        calibration_ref=is_ref)


def bench_section(system, bench: dict, *, batch_sizes,
                  band: tuple[float, float] = DEFAULT_BAND) -> dict:
    """The ``predicted_vs_measured`` record of a measured bench payload:

    * ``predict/<backend>`` (``torch``, ``cuda``): one model a backend,
      timed by ``bench["results"][f"{backend}_b{B}"]["us_per_batch"]``;
    * ``infer_step/cuda-<mode>`` (``off``, ``fused``, ``staged``): one
      model a metering mode, timed by ``bench["metered"]["results"]
      [f"metered_{mode}_b{B}"]["us_per_batch"]``;
    * ``orderings``: metered-fused over off at each batch (at least 1),
      and staged over off (recorded, not held).

    Every model is calibrated at the smallest batch, on the system's own
    cached sessions (``system.compile``) on its device."""
    from .runtime import RuntimeSpec

    batch_sizes = list(batch_sizes)
    b_ref = batch_sizes[0]
    dev = str(system.device)
    entries: dict[str, dict] = {}
    calibrations: dict[str, dict] = {}

    def run_family(family: str, spec: RuntimeSpec, entry: str,
                   measured) -> SweepCostModel:
        model = SweepCostModel(system.compile(spec), entry=entry)
        model.calibrate(b_ref, measured(b_ref))
        calibrations[family] = model.calibration
        for B in batch_sizes:
            entries[f"{family}_b{B}"] = _entry_record(
                model, B, measured(B), is_ref=B == b_ref)
        return model

    results = bench["results"]
    for impl in ("torch", "cuda"):
        run_family(f"predict/{impl}",
                   RuntimeSpec(backend=impl, metering="off", device=dev),
                   "predict",
                   lambda B, impl=impl:
                       results[f"{impl}_b{B}"]["us_per_batch"] / 1e6)

    metered = bench.get("metered", {}).get("results", {})
    models: dict[str, SweepCostModel] = {}
    for mode in ("off", "fused", "staged"):
        models[mode] = run_family(
            f"infer_step/cuda-{mode}",
            RuntimeSpec(backend="cuda", metering=mode, device=dev),
            "infer_step",
            lambda B, mode=mode:
                metered[f"metered_{mode}_b{B}"]["us_per_batch"] / 1e6)

    orderings = {}
    for B in batch_sizes:
        raw_off = models["off"].estimate(B).raw
        orderings[f"metered_fused_over_off_b{B}"] = dict(
            raw_cost_ratio=models["fused"].estimate(B).raw / raw_off,
            must_be_at_least=1.0)
        orderings[f"staged_over_off_b{B}"] = dict(
            raw_cost_ratio=models["staged"].estimate(B).raw / raw_off)
    return dict(band=list(band), calibration=calibrations,
                entries=entries, orderings=orderings)

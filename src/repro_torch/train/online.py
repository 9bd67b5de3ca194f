"""Online in-memory TA training under live traffic (arXiv:2408.09456), the
PyTorch port of ``repro.train.online``.

``OnlineTrainer`` runs the companion paper's update loop on an already
deployed ``IMPACTSystem``:

1. **Feedback sweep (analog read).**  Clause outputs come off the clause
   crossbar through the session backend's ``impact_clause_bits`` (the
   ``crossbar_mvm`` kernel on ``"cuda"``) with training semantics: an
   all-ones mask, so empty clauses fire.  Class votes come off the
   digital weight copy.
2. **TA transitions (kernel).**  The Type I/II deltas run through the
   session's ``ta_feedback`` entry (the ``ta_feedback`` kernel on
   ``"cuda"``, the plain version on ``"torch"``: the same bits).
3. **In-array write-back (pulse trains).**  Only TAs whose action
   flipped touch the array: ``pulse_until`` drives exactly those cells
   across the Boolean HCS/LCS boundary under the read path's D2D/C2C
   variability model (the per-device spread is sampled once per grid);
   changed weight cells re-tune the class tile within the fine-tune band.
4. **Billing.**  Write energy comes from the actual pulse counts via
   ``encode_energy`` into ``write_energy_j``; an update with no pulses
   bills exactly 0.0 J.

The write-back replaces the system's arrays and then calls
``refresh_operands()`` on every session compiled on the system (and on
the trainer's own), so serving between updates reads the new
conductances.  The reference's sessions re-read the system on every call;
the port's hold their operands, which is why the refresh is needed here.

Randomness comes from an explicit ``torch.Generator`` on the system's
device: the D2D spread at construction, then per update the feedback
draws (``core.train.FeedbackDraws``, which ``update`` also takes as an
operand) and the write path's C2C noise.
"""
from __future__ import annotations

from typing import Any

import torch

from ..core.cotm import CoTMConfig, CoTMParams, class_scores, include_mask
from ..core.train import (FeedbackDraws, apply_deltas, feedback_masks,
                          ta_draws, weight_deltas)
from ..impact import tiles as tiles_mod
from ..impact import yflash
from ..impact.energy import EnergyReport, encode_energy
from ..impact.tiles import weight_targets
from ..impact.yflash import (DeviceVariation, G_HCS_BOOL, G_LCS,
                             I_CSA_THRESHOLD, read_current)
from ..kernels.ref import pad_to


def _pad2(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """A (K, n) bool mask padded with False to (rows, cols)."""
    return pad_to(pad_to(x.to(torch.uint8), rows, 0), cols, 1).to(torch.bool)


class OnlineTrainer:
    """Interleaved in-array CoTM training on a deployed ``IMPACTSystem``.

    ``session`` must be a plain (single-tenant, unpacked) compiled session
    of the system being trained, on the system's device; its backend
    lowers the feedback sweep and ``ta_feedback``.  ``params`` are the
    digital TA/weight copies the system was encoded from.
    ``variability=False`` gives the ideal-device twin: no D2D spread, no
    C2C write noise.
    """

    def __init__(self, session, params: CoTMParams, cfg: CoTMConfig, *,
                 generator: torch.Generator, pulse_width: float = 1e-3,
                 class_pulse_width: float = 50e-6,
                 weight_tol_segments: float = 5.0, max_pulses: int = 64,
                 variability: bool = True, trace=None):
        if session.spec.coresident is not None:
            raise ValueError(
                "OnlineTrainer needs a single-tenant session — training "
                "writes re-program the shared fabric under a co-resident "
                "plan's feet (train the member system, then rebalance)")
        if session.packed:
            raise ValueError(
                "OnlineTrainer needs an unpacked session — the write path "
                "targets the f32 conductance grid")
        self.session = session
        self.system = sys_ = session.system
        dev = sys_.device
        if session._class_i.device != dev:
            raise ValueError(f"OnlineTrainer needs a session on the "
                             f"system's device {dev}, got {session.device}")
        if generator.device.type != dev.type:
            raise ValueError(f"generator lives on {generator.device}, the "
                             f"system on {dev}")
        self.generator = generator
        self.params = params.to(dev)
        self.cfg = cfg
        self.pulse_width = float(pulse_width)
        self.class_pulse_width = float(class_pulse_width)
        self.max_pulses = int(max_pulses)
        self.variability = bool(variability)
        self.trace = trace

        R, C, tr, tc = sys_.clause_i.shape
        S, sr, m = sys_.class_i.shape
        # The weight->conductance map is frozen at encode time: the same
        # unipolar shift and segment scale the class tile was programmed
        # with.  Weights past the encoded range saturate at the band
        # edges (a physical conductance range, not an error).
        self._shift = int(sys_.encode_stats["weight_shift"])
        self._w_max = max(int(sys_.encode_stats["weights"]["w_max"]), 1)
        seg = (yflash.G_RANGE_HI - yflash.G_RANGE_LO) / self._w_max
        self._w_tol = float(weight_tol_segments) * seg
        self._w_uni_pad = self._unipolar_padded(self.params.weights)

        # D2D variability is a property of the physical cells: sampled
        # once per grid here and reused by every write sweep.
        if self.variability:
            self._clause_var = DeviceVariation.sample(generator,
                                                      (R * tr, C * tc))
            self._class_var = DeviceVariation.sample(generator, (S * sr, m))
        else:
            self._clause_var = DeviceVariation.none((R * tr, C * tc),
                                                    device=dev)
            self._class_var = DeviceVariation.none((S * sr, m), device=dev)

        #: Running write meter (a left fold of the per-update bills, in
        #: update order).
        self.write_energy_j: float = 0.0
        self.records: list[dict[str, Any]] = []
        self.reports: list[EnergyReport] = []
        self._step = 0

    # -- helpers ------------------------------------------------------------
    def _unipolar_padded(self, weights: torch.Tensor) -> torch.Tensor:
        S, sr, _ = self.system.class_i.shape
        w_uni = torch.clamp(weights + self._shift, 0, self._w_max)
        return pad_to(w_uni.T.to(torch.int32), S * sr, 0)        # (S*sr, m)

    def _refresh_sessions(self) -> None:
        """Re-point every compiled session of the system (and the
        trainer's own) at the system's new operands."""
        sessions = list(self.system._sessions.values())
        if self.session not in sessions:
            sessions.append(self.session)
        for sess in sessions:
            sess.refresh_operands()

    def evaluate(self, literals, labels) -> float:
        """Held-out accuracy through the analog serving path (the session's
        ``predict``, which live traffic rides)."""
        preds = self.session.predict(literals).predictions
        labels = torch.as_tensor(labels, device=preds.device)
        return float((preds == labels).to(torch.float64).mean())

    # -- one update sweep ---------------------------------------------------
    def update(self, literals, labels,
               draws: FeedbackDraws | None = None) -> dict[str, Any]:
        """One batched Type I/II update: analog feedback sweep,
        ``ta_feedback`` deltas, in-array pulse-train write-back.  Returns
        the per-update billing record (also appended to ``records``, with
        a matching ``EnergyReport`` in ``reports``).  ``draws`` replaces
        the feedback draws of this update."""
        t0 = self.trace.clock() if self.trace is not None else 0.0
        cfg, sys_ = self.cfg, self.system
        dev = sys_.device
        lit = torch.as_tensor(literals, device=dev).to(torch.int8)
        labels = torch.as_tensor(labels, device=dev).to(torch.int64)
        B, K = lit.shape
        n, m = cfg.n_clauses, cfg.n_classes
        if draws is None:
            draws = FeedbackDraws.sample(self.generator, B, cfg)
        draws = draws.to(dev)

        # 1. Analog feedback sweep with training semantics (all-ones mask:
        # empty clauses fire); votes off the digital weight copy.
        inc = include_mask(self.params.ta_state, cfg.n_states)
        fired, i_col = self.session.backend.impact_clause_bits(
            lit, sys_.clause_i, torch.ones_like(sys_.nonempty),
            thresh=I_CSA_THRESHOLD)
        fired = fired[:, :n]
        scores = class_scores(fired, self.params.weights)

        # 2. Feedback masks (as ``core.train.batch_deltas``) + the kernel.
        tgt, pol, sel, match, fired2 = feedback_masks(
            fired, scores, self.params.weights, labels, draws, cfg)
        hi, lo = ta_draws(draws, cfg)
        ta_delta = self.session.ta_feedback(torch.cat([lit, lit]), fired2,
                                            sel, match, hi, lo, inc)
        w_delta = weight_deltas(tgt, pol, sel, fired2, m)
        new_params = apply_deltas(self.params, ta_delta, w_delta, cfg)

        # 3. Write-back: only action flips touch the clause array.
        R, C, tr, tc = sys_.clause_i.shape
        S, sr, _ = sys_.class_i.shape
        inc_new = include_mask(new_params.ta_state, cfg.n_states)
        flip = _pad2(inc_new != inc, R * tr, C * tc)
        inc_pad = _pad2(inc_new, R * tr, C * tc)
        g_cl = sys_.clause_g.permute(0, 2, 1, 3).reshape(R * tr, C * tc)
        # Untouched cells get the trivial band [0, inf): zero pulses by
        # construction, so an update with no flips bills exactly 0.0 J.
        inf = float("inf")
        tlo = torch.where(flip & inc_pad, G_HCS_BOOL, 0.0)
        thi = torch.where(flip, torch.where(inc_pad, inf, G_LCS), inf)
        g_cl, np_cl, ne_cl = yflash.pulse_until(
            g_cl, target_lo=tlo, target_hi=thi,
            width_prog=self.pulse_width, width_erase=self.pulse_width,
            var=self._clause_var, generator=self.generator,
            max_pulses=self.max_pulses, c2c=self.variability)
        unconv = tiles_mod.n_unconverged(g_cl, tlo, thi)

        # Changed weight cells re-tune within the fine-tune band.
        w_uni_new = self._unipolar_padded(new_params.weights)
        changed = w_uni_new != self._w_uni_pad
        target = weight_targets(w_uni_new, self._w_max)
        wlo = torch.where(changed, target - self._w_tol, 0.0)
        whi = torch.where(changed, target + self._w_tol, inf)
        g_cls, np_w, ne_w = yflash.pulse_until(
            sys_.class_g.reshape(S * sr, m), target_lo=wlo, target_hi=whi,
            width_prog=self.class_pulse_width,
            width_erase=self.class_pulse_width, var=self._class_var,
            generator=self.generator, max_pulses=self.max_pulses,
            c2c=self.variability)
        unconv += tiles_mod.n_unconverged(g_cls, wlo, whi)

        # 4. Bill the actual pulses (f64 host sums, like every meter).
        e_p_cl, e_e_cl = encode_energy(np_cl, ne_cl, self.pulse_width,
                                       self.pulse_width)
        e_p_w, e_e_w = encode_energy(np_w, ne_w, self.class_pulse_width,
                                     self.class_pulse_width)
        e_write = float(e_p_cl + e_e_cl + e_p_w + e_e_w)
        # The feedback sweep's clause read bills like any serving read.
        e_read = float(yflash.V_READ * float(i_col.to(torch.float64).sum())
                       * yflash.T_READ)

        # 5. Replace the system's arrays, then refresh every session.
        sys_.clause_g = g_cl.reshape(R, tr, C, tc).permute(
            0, 2, 1, 3).contiguous()
        sys_.clause_i = read_current(sys_.clause_g)
        sys_.class_g = g_cls.reshape(S, sr, m)
        sys_.class_i = read_current(sys_.class_g)
        sys_.nonempty = pad_to(inc_new.any(dim=0).to(torch.uint8), C * tc,
                               0).to(torch.bool)
        self._refresh_sessions()
        self.params = new_params
        self._w_uni_pad = w_uni_new

        record = dict(
            step=self._step,
            write_energy_j=e_write,
            read_energy_j=e_read,
            prog_pulses=int(np_cl.sum()) + int(np_w.sum()),
            erase_pulses=int(ne_cl.sum()) + int(ne_w.sum()),
            n_unconverged=int(unconv),
            n_flips=int((inc_new != inc).sum()),
            n_weight_cells=int(changed.sum()),
        )
        self.records.append(record)
        self.write_energy_j += e_write
        self.reports.append(EnergyReport(
            read_energy_j=e_read, clause_energy_j=e_read,
            class_energy_j=0.0,
            program_energy_j=sys_.encode_stats["program_energy_j"],
            erase_energy_j=sys_.encode_stats["erase_energy_j"],
            latency_s=sys_._grid_latency(), ops_crosspoint=B * K * n,
            datapoints=B, write_energy_j=e_write))
        self._step += 1
        if self.trace is not None:
            self.trace.span("train_update", t0, self.trace.clock(),
                            args=dict(step=record["step"],
                                      write_energy_j=e_write,
                                      n_flips=record["n_flips"],
                                      n_unconverged=record["n_unconverged"]))
        return record

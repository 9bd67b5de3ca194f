"""Backend registry: one lowering of the crossbar primitives per name (the
port of ``repro.kernels.backends``).

* ``"torch"`` — the plain PyTorch versions (``kernels.ref``), the
  counterpart of the reference's ``"xla"`` oracle backend;
* ``"cuda"`` — the hand-written CUDA kernels, the counterpart of
  ``"pallas"``.  Its kernel wrappers take the plain version for tensors
  on the CPU, so a ``"cuda"`` session compiled for ``device="cpu"`` runs
  the same routing with the plain arithmetic;
* ``"cuda-packed"`` — the counterpart of ``"pallas-packed"``: its
  unpacked ``fused_impact`` / ``fused_impact_metered`` pack the clause
  operand (``kernels.packing``) and launch the packed kernels.  A
  session on it holds the packed operand, packed once, whatever its
  spec's ``packing`` (``serves_packed``);
* ``"cuda-metered"`` — the counterpart of ``"pallas-metered"``: its
  ``fused_impact`` runs the metered kernel and drops the meters, so the
  unmetered entry points (``predict``, ``metering="off"``) ride the
  metered kernel on the same call path.

Every backend serves the 2-bit packed operand (``RuntimeSpec(packing=
"2bit")``): ``Backend.fused_impact_packed`` and its metered twin
dequantize and delegate, as in the reference (on ``"torch"`` that is the
packed plain version); ``"cuda"`` overrides them with the kernels that
unpack the codes on chip.

The staged analog compositions (``impact_clause_bits`` /
``impact_class_scores``, the Fig. 14 per-shard unroll over
``crossbar_mvm``) and the default ``fused_impact_metered`` live on the
``Backend`` base, as in the reference.  So do the four co-resident
primitives (``fused_impact_coresident`` and its metered / packed twins):
compositions over the staged pair with the per-lane tenant mask
(``ref.coresident_lane_mask``) between the clause and class stages, so
every backend serves a block-diagonal multi-tenant grid, the ``"cuda"``
backends through their ``crossbar_mvm`` kernel.  The kernels mask ragged edges
themselves, so no backend pads operands before a launch.  Rows that the
reference pads with zero drive (literal rows past K float, clause rows
past the clause tile) are left out of the compositions' launches
instead, which adds the same exact zeros.
"""
from __future__ import annotations

import torch

from . import class_sum as _class
from . import clause_eval as _clause
from . import crossbar_mvm as _mvm
from . import fused_cotm as _cotm
from . import fused_impact as _impact
from . import packing, ref
from . import ta_feedback as _feedback


class Backend:
    """One lowering of the crossbar primitives.  Subclass, set ``name``,
    implement the primitives and ``register_backend`` an instance."""

    name: str = ""
    #: A reference lowering launches no kernel of its own (the plain
    #: versions): the audit prices no working set for it.
    reference: bool = False
    #: A session on this backend holds the 2-bit packed clause operand
    #: (packed once, in ``InferenceSession.refresh_operands``) even when
    #: its spec asks for ``packing="none"``.
    serves_packed: bool = False

    # -- digital CoTM primitives --------------------------------------------
    def clause_eval(self, literals, include, nonempty, *,
                    mode: str = "fired") -> torch.Tensor:
        """-> fired (B, N) bool, or viol counts (B, N) int32 with
        ``mode="viol"``."""
        raise NotImplementedError

    def class_sum(self, clauses, weights) -> torch.Tensor:
        """clauses (B, N) x weights (N, M) -> scores (B, M) int32."""
        raise NotImplementedError

    def fused_cotm(self, literals, include, nonempty,
                   weights) -> torch.Tensor:
        """Both digital stages, weights (N, M) -> scores (B, M) int32."""
        raise NotImplementedError

    # -- analog crossbar primitives -----------------------------------------
    def crossbar_mvm(self, drive: torch.Tensor, g: torch.Tensor, *,
                     v_read: float = 2.0, nonlin: float = 1.5,
                     cutoff: float = 10e-9) -> torch.Tensor:
        raise NotImplementedError

    def fused_impact(self, literals, clause_i, nonempty, class_i, *,
                     thresh: float) -> torch.Tensor:
        raise NotImplementedError

    def fused_impact_metered(self, literals, clause_i, nonempty, class_i, *,
                             thresh: float,
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
        """-> (scores (B, M), per-lane summed clause-crossbar column
        currents (B,), per-lane summed class-crossbar column currents
        (B,)).  Default: the staged per-shard primitives, summing the
        column currents they already materialize."""
        fired, i_col = self.impact_clause_bits(literals, clause_i, nonempty,
                                               thresh=thresh)
        scores, i_cls = self.impact_class_scores(fired, class_i)
        return scores, i_col.sum(dim=(1, 2, 3)), i_cls.sum(dim=(1, 2))

    # -- 2-bit packed clause operand (kernels.packing layout) ---------------
    def pack_clause_operand(self, clause_i, *,
                            split=None) -> packing.PackedClause:
        """Quantize a clause-current operand to the 2-bit packed layout;
        ``split=None`` splits HCS from LCS at the device-population
        midpoint (``packing.population_split``)."""
        return packing.pack_clause_operand(clause_i, split=split)

    def fused_impact_packed(self, literals, packed: packing.PackedClause,
                            nonempty, class_i, *, thresh: float,
                            tr: int) -> torch.Tensor:
        """``fused_impact`` on a packed clause operand; ``tr`` is the
        unpacked rows of a shard.  Default: dequantize and delegate."""
        clause_i = packing.dequant_clause(packed.bits, packed.levels, tr)
        return self.fused_impact(literals, clause_i, nonempty, class_i,
                                 thresh=thresh)

    def fused_impact_packed_metered(self, literals,
                                    packed: packing.PackedClause, nonempty,
                                    class_i, *, thresh: float, tr: int,
                                    ) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
        """``fused_impact_metered`` on a packed clause operand; the meters
        bill the quantized currents.  Default: dequantize and delegate."""
        clause_i = packing.dequant_clause(packed.bits, packed.levels, tr)
        return self.fused_impact_metered(literals, clause_i, nonempty,
                                         class_i, thresh=thresh)

    # -- crossbar co-residency (block-diagonal multi-tenant grids) ---------
    def fused_impact_coresident(self, literals, clause_i, nonempty, class_i,
                                model_ids, clause_spans, *,
                                thresh: float) -> torch.Tensor:
        """``fused_impact`` on a block-diagonal co-resident grid with a
        per-lane tenant mask: ``model_ids`` (B,) int indexes
        ``clause_spans`` (T, 2) int32 ``[lo, hi)`` clause-column spans on
        the operands' device.  The mask gates each lane's fired bits to
        its own tenant's columns before the class stage (foreign columns
        draw 0 A, which the CSA would read as fired), so cross-tenant
        leakage is exactly zero (``ref.coresident_lane_mask``).  The
        staged pair, then the mask, then the class stage."""
        fired, _ = self.impact_clause_bits(literals, clause_i, nonempty,
                                           thresh=thresh)
        fired = fired & ref.coresident_lane_mask(model_ids, clause_spans,
                                                 fired.shape[1])
        scores, _ = self.impact_class_scores(fired, class_i)
        return scores

    def fused_impact_coresident_metered(
            self, literals, clause_i, nonempty, class_i, model_ids,
            clause_spans, *, thresh: float,
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Metered co-resident sweep, the triple of
        ``fused_impact_metered``; both per-lane meters are tenant-pure."""
        fired, i_col = self.impact_clause_bits(literals, clause_i, nonempty,
                                               thresh=thresh)
        fired = fired & ref.coresident_lane_mask(model_ids, clause_spans,
                                                 fired.shape[1])
        scores, i_cls = self.impact_class_scores(fired, class_i)
        return scores, i_col.sum(dim=(1, 2, 3)), i_cls.sum(dim=(1, 2))

    def fused_impact_coresident_packed(self, literals,
                                       packed: packing.PackedClause,
                                       nonempty, class_i, model_ids,
                                       clause_spans, *, thresh: float,
                                       tr: int) -> torch.Tensor:
        """Co-resident sweep on a 2-bit packed clause operand: dequantize
        and delegate."""
        clause_i = packing.dequant_clause(packed.bits, packed.levels, tr)
        return self.fused_impact_coresident(
            literals, clause_i, nonempty, class_i, model_ids, clause_spans,
            thresh=thresh)

    def fused_impact_coresident_packed_metered(
            self, literals, packed: packing.PackedClause, nonempty, class_i,
            model_ids, clause_spans, *, thresh: float, tr: int,
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Metered packed co-resident sweep: the meters bill the quantized
        currents, as ``fused_impact_packed_metered``'s do."""
        clause_i = packing.dequant_clause(packed.bits, packed.levels, tr)
        return self.fused_impact_coresident_metered(
            literals, clause_i, nonempty, class_i, model_ids, clause_spans,
            thresh=thresh)

    # -- online training ----------------------------------------------------
    def ta_feedback(self, lit2, fired2, sel, match, hi, lo,
                    include) -> torch.Tensor:
        """CoTM Type I/II TA feedback deltas over one doubled update batch
        -> ta_delta (K, n) int32 (``ref.ta_feedback_ref`` has the mask
        semantics).  Every draw is an operand, so every backend returns
        the same bits.  Default: the plain version."""
        return ref.ta_feedback_ref(lit2, fired2, sel, match, hi, lo,
                                   include)

    # -- staged analog compositions (Fig. 14 per-shard unroll) -------------
    def impact_clause_bits(self, literals, clause_i, nonempty, *,
                           thresh: float,
                           ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (fired (B, C*tc) bool, shard column currents (B, R, C, tc)):
        one ``crossbar_mvm`` per row shard over its rows below K (the rest
        float at 0 V), CSA threshold, digital AND over the R shards,
        ``nonempty`` mask."""
        B, K = literals.shape
        R, C, tr, tc = clause_i.shape
        drive = 1.0 - literals.to(torch.float32)
        cols = []
        for r in range(R):
            lo = r * tr
            rows = max(0, min(tr, K - lo))
            cur = clause_i[r, :, :rows].transpose(0, 1).reshape(rows, C * tc)
            cols.append(self.crossbar_mvm(drive[:, lo:lo + rows].contiguous(),
                                          cur.contiguous(), v_read=1.0,
                                          cutoff=0.0))
        i_col = torch.stack(cols, dim=1).reshape(B, R, C, tc)
        fired = torch.all(i_col < thresh, dim=1).reshape(B, C * tc)
        return fired & nonempty.to(torch.bool), i_col

    def impact_class_scores(self, clauses, class_i,
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (scores (B, M) = summed shard currents, currents (B, S, M)):
        one ``crossbar_mvm`` per class shard over its rows that hold a
        clause column (rows past the clause tile have no drive; clause
        columns past S*sr are dropped), then the digital add."""
        N = clauses.shape[1]
        S, sr, M = class_i.shape
        drive = clauses.to(torch.float32)
        cols = []
        for s in range(S):
            lo = s * sr
            rows = max(0, min(sr, N - lo))
            cols.append(self.crossbar_mvm(drive[:, lo:lo + rows].contiguous(),
                                          class_i[s, :rows], v_read=1.0,
                                          cutoff=0.0))
        i_col = torch.stack(cols, dim=1)
        return i_col.sum(dim=1), i_col


class CudaBackend(Backend):
    """The hand-written CUDA kernels (``csrc/*.cu``)."""

    name = "cuda"

    def clause_eval(self, literals, include, nonempty, *, mode="fired"):
        return _clause.clause_eval(literals.to(torch.int8).contiguous(),
                                   include.to(torch.bool).contiguous(),
                                   nonempty.to(torch.bool), mode=mode)

    def class_sum(self, clauses, weights):
        return _class.class_sum(clauses.to(torch.int8).contiguous(),
                                weights.to(torch.int32).contiguous())

    def fused_cotm(self, literals, include, nonempty, weights):
        return _cotm.fused_cotm(literals.to(torch.int8).contiguous(),
                                include.to(torch.bool).contiguous(),
                                weights.to(torch.int32).contiguous(),
                                nonempty.to(torch.bool))

    def ta_feedback(self, lit2, fired2, sel, match, hi, lo, include):
        b = lambda x: x.to(torch.bool).contiguous()
        i32 = lambda x: x.to(torch.int32).contiguous()
        return _feedback.ta_feedback(lit2.to(torch.int8).contiguous(),
                                     b(fired2), b(sel), b(match), i32(hi),
                                     i32(lo), b(include))

    def crossbar_mvm(self, drive, g, *, v_read=2.0, nonlin=1.5,
                     cutoff=10e-9):
        return _mvm.crossbar_mvm(drive.to(torch.float32),
                                 g.to(torch.float32), v_read=v_read,
                                 nonlin=nonlin, cutoff=cutoff)

    def fused_impact(self, literals, clause_i, nonempty, class_i, *,
                     thresh):
        return _impact.fused_impact(*self._fused_operands(
            literals, (clause_i.to(torch.float32),), nonempty, class_i),
            thresh=thresh)

    def fused_impact_metered(self, literals, clause_i, nonempty, class_i,
                             *, thresh):
        return _impact.fused_impact_metered(*self._fused_operands(
            literals, (clause_i.to(torch.float32),), nonempty, class_i),
            thresh=thresh)

    def fused_impact_packed(self, literals, packed, nonempty, class_i, *,
                            thresh, tr):
        return _impact.fused_impact_packed(*self._fused_operands(
            literals, packed, nonempty, class_i), thresh=thresh, tr=tr)

    def fused_impact_packed_metered(self, literals, packed, nonempty,
                                    class_i, *, thresh, tr):
        return _impact.fused_impact_packed_metered(*self._fused_operands(
            literals, packed, nonempty, class_i), thresh=thresh, tr=tr)

    @staticmethod
    def _fused_operands(literals, cells, nonempty, class_i):
        """The fused kernels' dtypes and layouts around the clause cells
        (``(clause_i,)`` or a ``PackedClause``): int8 literals, contiguous
        cells, bool nonempty, contiguous f32 class currents (no-ops for a
        session's own operands)."""
        return (literals.to(torch.int8).contiguous(),
                *(c.contiguous() for c in cells), nonempty.to(torch.bool),
                class_i.to(torch.float32).contiguous())


class CudaPackedBackend(CudaBackend):
    """The compressed lowering (the reference's ``PackedPallasBackend``):
    the unpacked fused primitives pack the clause operand and launch the
    packed kernels, so the f32 clause currents never reach a kernel."""

    name = "cuda-packed"
    serves_packed = True

    def fused_impact(self, literals, clause_i, nonempty, class_i, *,
                     thresh):
        return self.fused_impact_packed(
            literals, self.pack_clause_operand(clause_i), nonempty, class_i,
            thresh=thresh, tr=clause_i.shape[2])

    def fused_impact_metered(self, literals, clause_i, nonempty, class_i,
                             *, thresh):
        return self.fused_impact_packed_metered(
            literals, self.pack_clause_operand(clause_i), nonempty, class_i,
            thresh=thresh, tr=clause_i.shape[2])


class CudaMeteredBackend(CudaBackend):
    """The always-metered lowering (the reference's
    ``MeteredPallasBackend``): ``fused_impact`` runs the metered kernel
    and drops the meters, so ``predict`` and ``metering="off"`` ride the
    metered kernel on the same call path as the unmetered one, which
    prices the in-kernel meter one to one."""

    name = "cuda-metered"

    def fused_impact(self, literals, clause_i, nonempty, class_i, *,
                     thresh):
        scores, _, _ = self.fused_impact_metered(
            literals, clause_i, nonempty, class_i, thresh=thresh)
        return scores


class TorchBackend(Backend):
    """The plain PyTorch versions (``kernels.ref``): the parity oracle."""

    name = "torch"
    reference = True

    def clause_eval(self, literals, include, nonempty, *, mode="fired"):
        if mode == "viol":
            return ref.clause_viol_ref(literals, include)
        return ref.clause_eval_ref(literals, include, nonempty)

    def class_sum(self, clauses, weights):
        return ref.class_sum_ref(clauses, weights)

    def fused_cotm(self, literals, include, nonempty, weights):
        return ref.fused_cotm_ref(literals, include, weights, nonempty)

    def crossbar_mvm(self, drive, g, *, v_read=2.0, nonlin=1.5,
                     cutoff=10e-9):
        return ref.crossbar_mvm_ref(drive, g, v_read=v_read, nonlin=nonlin,
                                    cutoff=cutoff)

    def fused_impact(self, literals, clause_i, nonempty, class_i, *,
                     thresh):
        return ref.fused_impact_ref(literals, clause_i, nonempty, class_i,
                                    thresh=thresh)

    def impact_clause_bits(self, literals, clause_i, nonempty, *, thresh):
        return ref.impact_clause_bits_ref(literals, clause_i, nonempty,
                                          thresh=thresh)

    def impact_class_scores(self, clauses, class_i):
        return ref.impact_class_scores_ref(clauses, class_i)

    def fused_impact_coresident(self, literals, clause_i, nonempty, class_i,
                                model_ids, clause_spans, *, thresh):
        return ref.fused_impact_coresident_ref(
            literals, clause_i, nonempty, class_i, model_ids, clause_spans,
            thresh=thresh)

    def fused_impact_coresident_metered(self, literals, clause_i, nonempty,
                                        class_i, model_ids, clause_spans, *,
                                        thresh):
        return ref.fused_impact_coresident_metered_ref(
            literals, clause_i, nonempty, class_i, model_ids, clause_spans,
            thresh=thresh)


# -- registry ---------------------------------------------------------------

_REGISTRY: dict[str, Backend] = {}

#: The primitives every registered backend must provide (the reference's
#: contract; it has no interpret policy to resolve).
REQUIRED_PRIMITIVES: tuple[str, ...] = (
    "clause_eval", "class_sum", "fused_cotm", "crossbar_mvm",
    "fused_impact", "fused_impact_metered", "impact_clause_bits",
    "impact_class_scores", "ta_feedback", "pack_clause_operand",
    "fused_impact_packed", "fused_impact_packed_metered",
    "fused_impact_coresident", "fused_impact_coresident_metered",
    "fused_impact_coresident_packed",
    "fused_impact_coresident_packed_metered",
)


def register_backend(backend: Backend, *, overwrite: bool = False) -> Backend:
    """Register ``backend`` under ``backend.name``; refuses one that lacks a
    required primitive or would replace a registered name."""
    if not backend.name:
        raise ValueError("backend must define a non-empty .name")
    missing = [p for p in REQUIRED_PRIMITIVES
               if not callable(getattr(backend, p, None))]
    if missing:
        raise TypeError(
            f"backend {backend.name!r} does not satisfy the primitive "
            f"contract: {', '.join(missing)} missing or not callable "
            f"(see backends.REQUIRED_PRIMITIVES)")
    if backend.name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {backend.name!r} is already registered "
                         f"(pass overwrite=True to replace it)")
    _REGISTRY[backend.name] = backend
    return backend


def unregister_backend(name: str) -> Backend:
    """Remove a registered backend and return it (tests, plugin
    teardown)."""
    try:
        return _REGISTRY.pop(name)
    except KeyError:
        raise ValueError(f"backend {name!r} is not registered") from None


def get_backend(name: str | Backend) -> Backend:
    """Resolve a registry key (or pass a backend instance through)."""
    if isinstance(name, Backend):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; registered backends: "
                         f"{sorted(_REGISTRY)}") from None


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_backend(CudaBackend())
register_backend(CudaPackedBackend())
register_backend(CudaMeteredBackend())
register_backend(TorchBackend())

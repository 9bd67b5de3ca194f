"""Backend registry: one lowering of the crossbar primitives per name (the
port of ``repro.kernels.backends`` for this slice).

* ``"torch"`` — the plain PyTorch versions (``kernels.ref``), the
  counterpart of the reference's ``"xla"`` oracle backend;
* ``"cuda"`` — the hand-written CUDA kernels, the counterpart of
  ``"pallas"``.  Its kernel wrappers take the plain version for tensors
  on the CPU, so a ``"cuda"`` session compiled for ``device="cpu"`` runs
  the same routing with the plain arithmetic.

The staged analog compositions (``impact_clause_bits`` /
``impact_class_scores``, the Fig. 14 per-shard unroll over
``crossbar_mvm``) and the default ``fused_impact_metered`` live on the
``Backend`` base, as in the reference.  The kernels mask ragged edges
themselves, so no backend pads operands before a launch.  Rows that the
reference pads with zero drive (literal rows past K float, clause rows
past the clause tile) are left out of the compositions' launches
instead, which adds the same exact zeros.
"""
from __future__ import annotations

import torch

from . import crossbar_mvm as _mvm
from . import fused_impact as _impact
from . import ref


class Backend:
    """One lowering of the crossbar primitives.  Subclass, set ``name``,
    implement the primitives and ``register_backend`` an instance."""

    name: str = ""

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

    def crossbar_mvm(self, drive, g, *, v_read=2.0, nonlin=1.5,
                     cutoff=10e-9):
        return _mvm.crossbar_mvm(drive.to(torch.float32),
                                 g.to(torch.float32), v_read=v_read,
                                 nonlin=nonlin, cutoff=cutoff)

    def fused_impact(self, literals, clause_i, nonempty, class_i, *,
                     thresh):
        return _impact.fused_impact(*self._fused_operands(
            literals, clause_i, nonempty, class_i), thresh=thresh)

    def fused_impact_metered(self, literals, clause_i, nonempty, class_i,
                             *, thresh):
        return _impact.fused_impact_metered(*self._fused_operands(
            literals, clause_i, nonempty, class_i), thresh=thresh)

    @staticmethod
    def _fused_operands(literals, clause_i, nonempty, class_i):
        """The fused kernels' dtypes and layouts: int8 literals, bool
        nonempty, contiguous f32 currents (no-ops for a session's own
        operands)."""
        return (literals.to(torch.int8).contiguous(),
                clause_i.to(torch.float32).contiguous(),
                nonempty.to(torch.bool),
                class_i.to(torch.float32).contiguous())


class TorchBackend(Backend):
    """The plain PyTorch versions (``kernels.ref``): the parity oracle."""

    name = "torch"

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


# -- registry ---------------------------------------------------------------

_REGISTRY: dict[str, Backend] = {}

#: The primitives every registered backend must provide (this slice's cut
#: of the reference's contract).
REQUIRED_PRIMITIVES: tuple[str, ...] = (
    "crossbar_mvm", "fused_impact", "fused_impact_metered",
    "impact_clause_bits", "impact_class_scores",
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
register_backend(TorchBackend())

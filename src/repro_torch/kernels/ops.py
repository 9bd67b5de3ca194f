"""Public wrappers around the crossbar primitives (the port of
``repro.kernels.ops``).

Each wrapper resolves ``impl`` through the backend registry
(``kernels.backends``) and delegates: ``impl="cuda"`` runs the
hand-written kernels (their plain versions for tensors on the CPU),
``impl="torch"`` the plain PyTorch versions, and any registered backend
slots in without touching these call sites.

``fused_impact`` and ``fused_impact_packed`` also route to the
``torch.distributed`` lowering (``sharding.crossbar``) when a mesh is
passed and ``shard_plan`` finds a placement on its ``model`` axis,
including the asymmetric R-only / S-only plans where the operand that
does not divide is replicated; otherwise the single-device backend runs,
so callers can pass a mesh unconditionally.  On a mesh every rank calls
with the same full operands and gets the full result back.

The reference's ``interpret=`` and ``block_*`` arguments have no
counterpart: there is no interpret mode on the card, and each kernel
wrapper plans its own tiles from the shapes.
"""
from __future__ import annotations

import torch

from . import backends


def clause_eval(literals: torch.Tensor, include: torch.Tensor,
                nonempty: torch.Tensor | None = None, *,
                mode: str = "fired", impl: str = "cuda") -> torch.Tensor:
    """Boolean clause outputs (B, N) bool, or violation counts (B, N)
    int32 with ``mode="viol"``.

    literals (B, K) bool/{0,1}; include (K, N) bool/{0,1}; nonempty (N,)
    bool (defaults to ``include.any(0)``).
    """
    if nonempty is None:
        nonempty = include.to(torch.bool).any(dim=0)
    return backends.get_backend(impl).clause_eval(literals, include,
                                                  nonempty, mode=mode)


def class_sum(clauses: torch.Tensor, weights: torch.Tensor, *,
              impl: str = "cuda") -> torch.Tensor:
    """Class scores (B, M) int32 from clauses (B, N) and weights (N, M)."""
    return backends.get_backend(impl).class_sum(clauses, weights)


def fused_cotm(literals: torch.Tensor, include: torch.Tensor,
               weights: torch.Tensor, nonempty: torch.Tensor | None = None,
               *, impl: str = "cuda") -> torch.Tensor:
    """Both digital stages, literals -> class scores (B, M) int32.
    ``weights`` is (N, M), the class crossbar's layout."""
    if nonempty is None:
        nonempty = include.to(torch.bool).any(dim=0)
    return backends.get_backend(impl).fused_cotm(literals, include,
                                                 nonempty, weights)


def _plan(mesh, R: int, S: int):
    if mesh is None:
        return None
    from ..sharding import crossbar   # crossbar imports this module
    return crossbar.shard_plan(mesh, R, S)


def fused_impact(literals: torch.Tensor, clause_i: torch.Tensor,
                 nonempty: torch.Tensor, class_i: torch.Tensor, *,
                 thresh: float, impl: str = "cuda", mesh=None,
                 meter: bool = False):
    """Fused analog IMPACT inference: literals -> class currents (B, M) f32.

    literals (B, K) bool/{0,1}; clause_i (R, C, tr, tc) f32 per-cell
    clause crossbar read currents in the ``IMPACTSystem`` shard layout;
    nonempty (C*tc,) digital mask; class_i (S, sr, M) f32 class crossbar
    currents; ``thresh`` the CSA decision current
    (``yflash.I_CSA_THRESHOLD``).

    ``meter=True`` also returns the per-lane energy meters: ``(scores,
    summed clause-crossbar column currents (B,), summed class-crossbar
    column currents (B,))``.

    ``mesh`` (a ``DeviceMesh`` with a ``model`` axis, from
    ``launch.mesh``) distributes the R / S row shards over the ranks
    through ``sharding.crossbar`` and shards the batch over the data
    axes, when ``shard_plan`` finds a placement; otherwise the
    single-device backend runs.
    """
    R, C, tr, tc = clause_i.shape
    S = class_i.shape[0]
    if nonempty.shape != (C * tc,):
        raise ValueError(f"nonempty has shape {tuple(nonempty.shape)}, the "
                         f"clause grid {C * tc} columns")
    plan = _plan(mesh, R, S)
    if plan is not None:
        from ..sharding import crossbar
        return crossbar.fused_impact_sharded(
            literals, clause_i, nonempty, class_i, thresh=thresh, mesh=mesh,
            impl=impl, meter=meter, shard_r=plan[0], shard_s=plan[1])
    backend = backends.get_backend(impl)
    if meter:
        return backend.fused_impact_metered(literals, clause_i, nonempty,
                                            class_i, thresh=thresh)
    return backend.fused_impact(literals, clause_i, nonempty, class_i,
                                thresh=thresh)


def fused_impact_packed(literals: torch.Tensor, packed,
                        nonempty: torch.Tensor, class_i: torch.Tensor, *,
                        thresh: float, tr: int, impl: str = "cuda-packed",
                        mesh=None, meter: bool = False):
    """``fused_impact`` on a bitplane-packed clause operand.

    ``packed`` is a ``kernels.packing.PackedClause`` (2-bit codes
    ``(R, C, ceil(tr/4), tc)`` uint8 and the ``(2,)`` levels) and ``tr``
    the unpacked rows of a shard.  Routing mirrors ``fused_impact``; the
    sharded lowering unpacks each rank's bitplanes per shard.
    ``meter=True`` returns the metered triple billed on the quantized
    currents.
    """
    R, C, _, tc = packed.bits.shape
    S = class_i.shape[0]
    if nonempty.shape != (C * tc,):
        raise ValueError(f"nonempty has shape {tuple(nonempty.shape)}, the "
                         f"clause grid {C * tc} columns")
    plan = _plan(mesh, R, S)
    if plan is not None:
        from ..sharding import crossbar
        return crossbar.fused_impact_sharded(
            literals, None, nonempty, class_i, thresh=thresh, mesh=mesh,
            impl=impl, meter=meter, shard_r=plan[0], shard_s=plan[1],
            packed=packed, packed_tr=tr)
    backend = backends.get_backend(impl)
    if meter:
        return backend.fused_impact_packed_metered(
            literals, packed, nonempty, class_i, thresh=thresh, tr=tr)
    return backend.fused_impact_packed(literals, packed, nonempty, class_i,
                                       thresh=thresh, tr=tr)


def crossbar_mvm(drive: torch.Tensor, g: torch.Tensor, *,
                 v_read: float = 2.0, nonlin: float = 1.5,
                 cutoff: float = 10e-9, impl: str = "cuda") -> torch.Tensor:
    """Analog crossbar column currents (B, N) f32: drive (B, K) @ (g *
    v_read * nl(g)) with the low-conductance read nonlinearity."""
    return backends.get_backend(impl).crossbar_mvm(
        drive, g, v_read=v_read, nonlin=nonlin, cutoff=cutoff)

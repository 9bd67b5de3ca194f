"""Clause pruning of a programmed IMPACT system, and the int8 gradient
all-reduce of LM training (the port of ``repro.train.compression``).

``prune_clauses`` is a post-training pass over a programmed
``IMPACTSystem`` that (a) retires the clause columns that never fire on a
calibration batch, so their cells stop drawing leakage current every
sweep, and (b) merges duplicate clause columns (identical at the ternary
device abstraction of ``kernels.packing``) by summing their class-crossbar
rows, exact on ideal devices because the class read is linear in the
drive.  ``PruneStats`` re-anchors Table 4's energy per *effective*
clause.  It pairs with ``RuntimeSpec(packing="2bit")``: pruning shrinks
the live column population, packing the bytes per column.

``int8_psum`` all-reduces a tensor over a ``torch.distributed`` group
with int8 on the wire: a shared input scale (a MAX all-reduce), a
reduce-scatter as an int8 ``all_to_all_single`` summed in int32, a
requantization and an int8 ``all_gather``.
``compressed_grad_allreduce`` wraps it with error feedback.  The
arithmetic is the reference's op for op (f32 divisions, ``torch.round``
half to even as ``jnp.round``, the residual rounded once as XLA's fused
multiply-add), so the result and the residual are the reference's bit
for bit.  The collectives run on gloo, which takes host
tensors: every operand of a collective is staged through host memory,
whatever device the tensor lives on, and the quantization runs on the
tensor's own device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..impact import energy as energy_mod
from ..impact import yflash
from ..kernels import backends, packing
from ..models.base import leaves, unflatten


@dataclasses.dataclass(frozen=True)
class PruneStats:
    """What a :func:`prune_clauses` pass removed, and the re-anchored
    Table 4 figure: ``energy_per_effective_clause_j`` is the pruned
    system's read energy per calibration datapoint per effective clause
    (``impact.energy.energy_per_effective_clause``)."""
    n_clauses: int
    n_effective: int
    n_never_fired: int
    n_duplicates: int
    calibration_batch: int
    energy_per_effective_clause_j: float


def _g_from_current(i: np.ndarray, *, v_read: float, nonlin: float,
                    cutoff: float) -> np.ndarray:
    """Exact inverse of ``yflash.read_current`` (piecewise linear): the
    conductance that reads back as current ``i``."""
    return np.where(i >= cutoff * v_read, i / v_read, i / (v_read * nonlin))


def prune_clauses(system, literals, *, merge_duplicates: bool = True):
    """Prune a programmed ``IMPACTSystem`` against a calibration batch.

    Both reductions are physical erases on the clause crossbar: a retired
    column's cells go to 0 S and 0 A and its ``nonempty`` bit clears, so
    it neither fires nor leaks.

    1. **Never-fired columns**: clauses that fire on no calibration
       datapoint (exact on that batch; elsewhere the usual calibration
       bet).
    2. **Duplicate columns** (``merge_duplicates=True``): columns with
       identical ternary codes compute the same clause, so all but the
       first (in ascending column order) are erased and their class rows
       are added, in f32 and in that order, into the first's row; the
       class conductances are recomputed from the merged currents.

    The fired bits and the meters come from the ``"cuda"`` backend on the
    system's device: the kernels on a card, their plain versions on the
    CPU.  The merge is a one-off pass on the host.  Returns ``(pruned,
    PruneStats)``; ``pruned`` is a new system of the same geometry on the
    same device, with the record in ``encode_stats["pruning"]``.
    """
    dev = system.device
    backend = backends.get_backend("cuda")
    lits = torch.as_tensor(literals, device=dev).to(torch.int8)
    B = int(lits.shape[0])
    R, C, tr, tc = system.clause_i.shape
    S, sr, M = system.class_i.shape
    n_pad = C * tc
    nonempty_eff = system._nonempty_eff()
    nonempty = nonempty_eff.cpu().numpy().astype(bool)

    fired, _ = backend.impact_clause_bits(
        lits, system.clause_i, nonempty_eff, thresh=yflash.I_CSA_THRESHOLD)
    ever = fired.any(dim=0).cpu().numpy()
    alive = nonempty & ever
    n_never = int((nonempty & ~ever).sum())

    clause_i = system.clause_i.cpu().numpy().astype(np.float32)
    clause_g = system.clause_g.cpu().numpy().astype(np.float32)
    class_i = system.class_i.cpu().numpy().astype(np.float32)
    class_g = system.class_g.cpu().numpy().astype(np.float32)
    # Clause column j lives at tile (j // tc, j % tc) and is class-crossbar
    # flat row j (n_clauses <= S*sr by construction).
    cls_i_flat = class_i.reshape(S * sr, M)

    n_dup = 0
    if merge_duplicates:
        flat_ci = system.clause_i.permute(0, 2, 1, 3).reshape(R * tr, n_pad)
        codes = packing.classify_currents(flat_ci).cpu().numpy()
        keep_of: dict[bytes, int] = {}
        for j in np.flatnonzero(alive):
            keep = keep_of.setdefault(codes[:, j].tobytes(), int(j))
            if keep != j:
                cls_i_flat[keep] += cls_i_flat[j]
                cls_i_flat[j] = 0.0
                alive[j] = False
                n_dup += 1
        class_g = _g_from_current(
            class_i, v_read=yflash.V_READ, nonlin=yflash.LCS_NONLINEARITY,
            cutoff=yflash.G_NONLIN_CUTOFF).astype(np.float32)

    # Erase every retired column: cells to 0 S / 0 A, nonempty cleared.
    dead = nonempty & ~alive
    col_mask = (~dead).reshape(C, tc)[None, :, None, :]
    clause_i *= col_mask
    clause_g *= col_mask
    new_nonempty = system.nonempty.cpu().numpy().astype(bool) & ~dead

    t = lambda a: torch.as_tensor(a, device=dev).contiguous()
    pruned = dataclasses.replace(
        system, clause_g=t(clause_g), clause_i=t(clause_i),
        class_g=t(class_g), class_i=t(class_i), nonempty=t(new_nonempty))

    n_eff = int(alive.sum())
    _, i_cl, i_cs = backend.fused_impact_metered(
        lits, pruned.clause_i, pruned._nonempty_eff(), pruned.class_i,
        thresh=yflash.I_CSA_THRESHOLD)
    read_j = float(yflash.V_READ * yflash.T_READ
                   * (i_cl.double().sum() + i_cs.double().sum()))
    stats = PruneStats(
        n_clauses=int(system.n_clauses), n_effective=n_eff,
        n_never_fired=n_never, n_duplicates=n_dup, calibration_batch=B,
        energy_per_effective_clause_j=energy_mod.energy_per_effective_clause(
            read_j, B, n_eff))
    pruned.encode_stats = dict(system.encode_stats,
                               pruning=dataclasses.asdict(stats))
    return pruned, stats


# -- int8 gradient compression ----------------------------------------------

def _scale(x: torch.Tensor, group) -> torch.Tensor:
    """The shared scale of a tensor whose largest magnitude on this rank
    is ``x`` (0-d): a MAX all-reduce (through a host copy) over 127.  The
    reference writes ``/ 127.0``, which XLA compiles into a multiply by
    the f32 reciprocal; so does this, bit for bit."""
    h = x.detach().to("cpu", copy=True).reshape(1)
    dist.all_reduce(h, op=dist.ReduceOp.MAX, group=group)
    return h[0].to(x.device) * torch.tensor(1 / 127, dtype=x.dtype,
                                            device=x.device)


def _quantize(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.round(v / torch.clamp(scale, min=1e-30))
    return torch.clamp(q, -127, 127).to(torch.int8)


def int8_psum(v: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``v`` over the ranks of ``group`` (default: the world),
    int8 on the wire; every rank calls it and gets the same result.  The
    flattened tensor is zero-padded to a multiple of the group size for
    the all_to_all phase."""
    n = dist.get_world_size(group)
    shape, dev = v.shape, v.device
    flat = v.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])

    # Phase 1: shared input scale.
    scale1 = _scale(torch.max(torch.abs(flat)), group)
    q = _quantize(flat, scale1).reshape(n, -1)

    # Phase 2: reduce-scatter via all_to_all (int8 on the wire): row j of
    # every rank goes to rank j.
    shards = torch.empty_like(q, device="cpu")
    dist.all_to_all_single(shards, q.to("cpu", copy=True), group=group)
    local_sum = shards.to(dev).to(torch.int32).sum(0, dtype=torch.int32)
    local_f = local_sum.to(torch.float32) * scale1

    # Phase 3: requantize + all-gather (int8 on the wire).
    scale2 = _scale(torch.max(torch.abs(local_f)), group)
    q2 = _quantize(local_f, scale2).to("cpu", copy=True)
    gathered = [torch.empty_like(q2) for _ in range(n)]
    dist.all_gather(gathered, q2, group=group)
    out = torch.stack(gathered).to(dev).to(torch.float32).reshape(-1) \
        * scale2
    return out[:flat.numel() - pad][:v.numel()].reshape(shape)


def compressed_grad_allreduce(grads, errors, group=None):
    """Error feedback around ``int8_psum``: each leaf sends ``g + e`` and
    keeps as its new error what phase 1's quantization lost of it.
    Trees of dicts and lists of tensors -> (summed grads, new errors)."""
    totals, new_errors = [], []
    for (_, g), (_, e) in zip(leaves(grads), leaves(errors)):
        v = g.to(torch.float32) + e
        totals.append(int8_psum(v, group))
        # v - q * scale rounded once, as the reference's compiled
        # residual (XLA contracts it into a fused multiply-add): the
        # product of an int8 and an f32 is exact in f64, and so is the
        # difference of these two near values; one rounding to f32 then
        # gives the same bits on any device.
        new_errors.append((v.double() - _roundtrip(v, group, torch.float64))
                          .float())
    return unflatten(grads, totals), unflatten(grads, new_errors)


def _roundtrip(v: torch.Tensor, group=None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """This rank's contribution as it survives phase 1's quantization:
    the reference point of the error-feedback residual, in ``dtype``
    (f32 as the reference's; in f64 the product is exact)."""
    flat = v.reshape(-1)
    scale1 = _scale(torch.max(torch.abs(flat)), group)
    q = _quantize(flat, scale1)
    return (q.to(dtype) * scale1.to(dtype)).reshape(v.shape)

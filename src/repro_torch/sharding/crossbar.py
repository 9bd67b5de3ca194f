"""Distributed lowering of the fused analog IMPACT crossbar over
``torch.distributed`` (the port of ``repro.sharding.crossbar``).

The paper's Fig. 14 modular scaling is a sum decomposition (``rules.py``):
partial clauses from the R literal row-shards are combined by a digital
AND, and partial class currents from the S class row-shards are
digitised per shard (ADC) and summed.  Here it runs on a mesh of
processes (``launch.mesh``): the ``model`` axis holds the clause and/or
class row-shards, the batch shards over the data axes (``("pod",
"data")`` when present), and

* the digital AND is an ``all_reduce`` (SUM) over the model group of
  the per-rank violation counts (a column fires iff no shard on any rank
  sees current at or above the CSA threshold);
* the per-shard ADC and digital add is an ``all_reduce`` over the model
  group of the per-rank partial class currents (exact in the arithmetic:
  the class read is linear in the drive).

**SPMD.**  One process a rank.  Every rank calls ``fused_impact_sharded``
with the same full operands and gets the full result back, the
counterpart of the reference's global output.  A rank runs the
``crossbar_mvm`` primitive (``ops.crossbar_mvm``, the ``"cuda"`` kernel
on a card) once for each of its local clause shards (once for each
bitplane of them when packed) and once for each of its local class
shards, so the single-device staged path and the distributed lowering
share one numerical core.  Each rank writes its batch rows into a zeroed
full-size output, and the same reduction assembles the batch: adding
zeros is exact, so no ``all_gather`` is needed.

**Asymmetric plans.**  When only one of R and S divides the model axis,
that operand shards and the other is replicated: every rank evaluates
the replicated stage in full (its inputs are fully known on the rank
after the other stage's reduction), so no combine is needed for it.
``shard_plan`` picks the placement: ``(True, True)`` fully sharded,
``(True, False)`` / ``(False, True)`` R-only / S-only, ``None`` no usable
plan (the single-device kernels run; correctness never depends on the
mesh).

**Energy metering.**  ``meter=True`` sums the per-lane column currents
of both crossbars over the model axis for the partial stages only: a
replicated stage's currents are already the full quantity on every rank,
so only the first rank of the model axis contributes them to the sum,
and nothing is billed twice.  This one lowering backs both metered modes
of a sharded session (``"staged"`` and ``"fused"``), as in the
reference.

**Collectives.**  Only ``all_reduce`` (SUM), on tensors of the rank's
own device, over the groups of the mesh's axes.  Over ``gloo`` (the way
``launch.mesh.spawn`` starts a world) that works for CPU and CUDA
tensors, so several ranks may share one card; the reduction itself runs
on the host, which a CUDA graph cannot hold.  So the lowering is split
into its local stages around the two collectives (``ShardedCall``): a
session on a card captures each stage into a graph of its own and runs
the collectives between the replays.

Parity contract (``tests/test_torch_sharding.py``, against the
reference's ``fused_impact_shmap``): CSA bits and argmax exactly equal
on ideal devices; scores at rtol 1e-6; lane meters at rtol 1e-5.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..kernels import ops, packing
from ..launch.mesh import axis_sizes
from .rules import crossbar_rules

#: Topology shard modes accepted by ``shard_plan`` / ``Topology.shard``.
SHARD_MODES = ("auto", "both", "r", "s", "none")


def model_size(mesh) -> int:
    """Size of the ``model`` axis (1 when absent or no mesh)."""
    if mesh is None:
        return 1
    return int(axis_sizes(mesh).get("model", 1))


def data_axes(mesh) -> tuple[str, ...]:
    """The batch axes of ``mesh`` actually present, in rule-table order."""
    if mesh is None:
        return ()
    sizes = axis_sizes(mesh)
    return tuple(a for a in crossbar_rules(mesh)["batch"] if a in sizes)


def shard_plan(mesh, n_row_shards: int, n_class_shards: int,
               mode: str = "auto") -> tuple[bool, bool] | None:
    """Resolve the (shard_r, shard_s) placement of an (R, S) grid on
    ``mesh``'s model axis, or ``None`` when nothing can shard.

    ``mode``: ``"auto"`` shards whichever of R / S divides the axis
    (both when both do); ``"both"`` / ``"r"`` / ``"s"`` demand that
    placement and raise ``ValueError`` when the shard count doesn't
    divide the axis (compile-time validation for explicit topologies);
    ``"none"`` always returns ``None`` (force single-device).
    """
    if mode not in SHARD_MODES:
        raise ValueError(f"shard mode must be one of {SHARD_MODES}, "
                         f"got {mode!r}")
    m = model_size(mesh)
    if mode == "none":
        return None
    if m <= 1:
        if mode == "auto":
            return None
        raise ValueError(
            f"shard mode {mode!r} demands a sharded placement but the "
            f"mesh has no model axis larger than 1 (model={m})")
    r_ok = n_row_shards % m == 0
    s_ok = n_class_shards % m == 0
    if mode == "auto":
        return (r_ok, s_ok) if (r_ok or s_ok) else None
    want_r = mode in ("both", "r")
    want_s = mode in ("both", "s")
    if (want_r and not r_ok) or (want_s and not s_ok):
        raise ValueError(
            f"shard mode {mode!r} needs "
            f"{'R=' + str(n_row_shards) if want_r and not r_ok else ''}"
            f"{' and ' if want_r and not r_ok and want_s and not s_ok else ''}"
            f"{'S=' + str(n_class_shards) if want_s and not s_ok else ''} "
            f"to divide the model axis ({m} devices)")
    return (want_r, want_s)


def shardable(mesh, n_row_shards: int, n_class_shards: int) -> bool:
    """True when any shard plan exists for the (R, S) grid on ``mesh``:
    fully sharded or asymmetric (one operand replicated)."""
    return shard_plan(mesh, n_row_shards, n_class_shards) is not None


# -- this rank's part of the grid and of the batch ---------------------------

def local_shards(mesh, n_shards: int, sharded: bool) -> range:
    """The shards of an operand this rank holds: its own 1/model slice
    when the operand shards over the model axis, else all of them."""
    if not sharded:
        return range(n_shards)
    per = n_shards // model_size(mesh)
    i = mesh.get_local_rank("model")
    return range(i * per, (i + 1) * per)


def batch_rows(mesh, batch: int) -> tuple[slice, bool]:
    """(the rows of a ``batch`` this rank computes, whether the batch is
    sharded): its own slice of the data axes (``("pod", "data")`` in
    that order) when ``batch`` divides them, else every row (the batch
    replicates rather than fails; the model axis still shards)."""
    sizes = axis_sizes(mesh)
    axes = data_axes(mesh)
    n_data = math.prod(sizes[a] for a in axes)
    if n_data == 1 or batch % n_data:
        return slice(0, batch), False
    i = 0
    for a in axes:
        i = i * sizes[a] + mesh.get_local_rank(a)
    per = batch // n_data
    return slice(i * per, (i + 1) * per), True


def clause_calls(K: int, tr: int, shards: range,
                 packed: bool) -> list[tuple[int, int, int, int]]:
    """The ``crossbar_mvm`` calls of a rank's clause stage, as (local
    shard index, bitplane or -1, first literal row, rows) tuples: one a
    shard over its rows below K (rows past K float at 0 V), or with a
    packed operand one a bitplane j of them, which drives the shard's
    rows 4q + j.  A shard or plane with no driven row makes no call: its
    currents are 0 A."""
    calls = []
    for i, r in enumerate(shards):
        lo = r * tr
        rows = max(0, min(tr, K - lo))
        if not packed:
            if rows:
                calls.append((i, -1, lo, rows))
            continue
        for j in range(packing.CELLS_PER_BYTE):
            k = -(-(rows - j) // packing.CELLS_PER_BYTE) if rows > j else 0
            if k:
                calls.append((i, j, lo, k))
    return calls


def class_calls(N: int, sr: int, shards: range) -> list[tuple[int, int,
                                                                 int]]:
    """The ``crossbar_mvm`` calls of a rank's class stage, as (local shard
    index, first clause row, rows) tuples: one a class shard over its rows
    that hold one of the N clause columns."""
    calls = []
    for i, s in enumerate(shards):
        lo = s * sr
        rows = max(0, min(sr, N - lo))
        if rows:
            calls.append((i, lo, rows))
    return calls


def local_mvm_calls(mesh, K: int, R: int, tr: int, C: int, tc: int, S: int,
                    sr: int, M: int, *, plan: tuple[bool, bool],
                    packed: bool) -> list[tuple[int, int]]:
    """(K, N) of each ``crossbar_mvm`` call one sweep makes on this rank,
    clause calls first: what the session prices and the lowering
    launches."""
    rs = local_shards(mesh, R, plan[0])
    ss = local_shards(mesh, S, plan[1])
    return ([(k, C * tc) for _, _, _, k in clause_calls(K, tr, rs, packed)]
            + [(k, M) for _, _, k in class_calls(C * tc, sr, ss)])


# -- the local stages ---------------------------------------------------------

def _local_column_currents(drive: torch.Tensor, ci_loc: torch.Tensor,
                           shards: range, *, impl: str) -> torch.Tensor:
    """Clause-crossbar column currents of this rank's row shards.

    drive (B, K) f32 row drive of every literal; ci_loc (R_loc, C, tr, tc)
    f32 read currents of the shards in ``shards`` -> (B, R_loc, C*tc)
    f32.  One ``crossbar_mvm`` a shard, as on the single-device staged
    path."""
    B, K = drive.shape
    R_loc, C, tr, tc = ci_loc.shape
    i_col = torch.zeros((B, R_loc, C * tc), dtype=torch.float32,
                        device=drive.device)
    for i, _, lo, k in clause_calls(K, tr, shards, packed=False):
        cur = ci_loc[i, :, :k].transpose(0, 1).reshape(k, C * tc)
        i_col[:, i] = ops.crossbar_mvm(drive[:, lo:lo + k].contiguous(),
                                       cur.contiguous(), v_read=1.0,
                                       cutoff=0.0, impl=impl)
    return i_col


def _local_column_currents_packed(drive: torch.Tensor, pb_loc: torch.Tensor,
                                  levels: torch.Tensor, tr: int,
                                  shards: range, *,
                                  impl: str) -> torch.Tensor:
    """Packed-operand twin of ``_local_column_currents``.

    pb_loc (R_loc, C, ceil(tr/4), tc) uint8 codes of the shards in
    ``shards``, ``levels`` (2,) the dequant levels, ``tr`` the unpacked
    rows of a shard -> (B, R_loc, C*tc) f32.  Each
    bitplane j is dequantized on the rank and driven through the same
    ``crossbar_mvm`` by the shard's rows 4q + j; the planes' currents add
    in plane order."""
    B, K = drive.shape
    R_loc, C, _, tc = pb_loc.shape
    i_col = torch.zeros((B, R_loc, C * tc), dtype=torch.float32,
                        device=drive.device)
    for i, j, lo, k in clause_calls(K, tr, shards, packed=True):
        codes = (pb_loc[i, :, :k] >> (2 * j)) & 3
        cur = packing.dequant_codes(codes, levels)
        cur = cur.transpose(0, 1).reshape(k, C * tc)
        rows = drive[:, lo + j:lo + j + packing.CELLS_PER_BYTE * k:
                     packing.CELLS_PER_BYTE]
        i_col[:, i] += ops.crossbar_mvm(rows.contiguous(), cur.contiguous(),
                                        v_read=1.0, cutoff=0.0, impl=impl)
    return i_col


def _all_reduce(t: torch.Tensor, mesh, axes: tuple[str, ...]) -> None:
    """Sum ``t`` in place over the mesh groups of ``axes`` (those larger
    than one rank)."""
    sizes = axis_sizes(mesh)
    for a in axes:
        if sizes[a] > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM,
                            group=mesh.get_group(a))


class ShardedCall:
    """One sharded call's local stages on this rank, around its two
    collectives: ``clause_stage`` (drive to the partial violation
    counts), ``reduce_viol``, ``class_stage`` (fired bits to the partial
    output rows), ``reduce_out`` and ``tail`` (scores and meters sliced
    out of the summed output).  ``fused_impact_sharded`` runs them in
    that order; a session on a card captures each stage into a CUDA graph
    of its own and runs the collectives between the replays.

    Everything the constructor computes (this rank's batch rows, its
    local shards, whether it is the model axis's first rank) is a Python
    value fixed by the mesh and the shapes, so a captured stage holds it
    as a constant."""

    def __init__(self, B: int, K: int, clause_shape: tuple[int, ...],
                 class_shape: tuple[int, ...], *, thresh: float, mesh,
                 impl: str, meter: bool, shard_r: bool, shard_s: bool,
                 packed_tr: int | None = None):
        R, C, tr, tc = clause_shape
        S, sr, M = class_shape
        m = model_size(mesh)
        if not (shard_r or shard_s):
            raise ValueError("no-op plan: use the single-device kernels")
        if (shard_r and R % m) or (shard_s and S % m):
            raise ValueError(f"plan ({shard_r}, {shard_s}) needs R={R} and "
                             f"S={S} to divide the model axis ({m})")
        self.mesh, self.thresh, self.impl, self.meter = mesh, thresh, impl, meter
        self.shard_r, self.shard_s = shard_r, shard_s
        self.B, self.K, self.M, self.n = B, K, M, C * tc
        self.tr = tr if packed_tr is None else packed_tr
        self.rows, self.batch_sharded = batch_rows(mesh, B)
        self.rs = local_shards(mesh, R, shard_r)
        self.ss = local_shards(mesh, S, shard_s)
        self.sr = sr
        # (whether each part of the output is a partial sum over the model
        # axis): the class currents, then the two meters.
        self.partial = (shard_s,) + ((shard_r, shard_s) if meter else ())
        self.reduce_model = any(self.partial)
        # A replicated quantity enters the model sum from the axis's first
        # rank only (the others add exact zeros), so it is billed once.
        self.first = (not self.reduce_model
                      or mesh.get_local_rank("model") == 0)

    def clause_stage(self, literals: torch.Tensor, clause_i, packed=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """literals (B, K) -> (this rank's violation counts (b, n) int32,
        its clause column currents (b, R_loc, n) f32) on its rows."""
        rs = self.rs
        drive = 1.0 - literals[self.rows].to(torch.float32)
        if packed is not None:
            i_col = _local_column_currents_packed(
                drive, packed.bits[rs.start:rs.stop], packed.levels, self.tr,
                rs, impl=self.impl)
        else:
            i_col = _local_column_currents(drive, clause_i[rs.start:rs.stop],
                                           rs, impl=self.impl)
        # Partial CSA bits: the local shards whose column current trips the
        # sense amp.  With R sharded the sum over the model group is Fig.
        # 14's digital AND (a clause fires iff the total is zero); with R
        # replicated the local count is already the total.
        viol = (i_col >= self.thresh).to(torch.int32).sum(dim=1)
        return viol, i_col

    def reduce_viol(self, viol: torch.Tensor) -> None:
        """The digital AND: ``viol`` summed in place over the model axis
        when R shards."""
        if self.shard_r:
            _all_reduce(viol, self.mesh, ("model",))

    def class_stage(self, viol: torch.Tensor, i_col: torch.Tensor,
                    nonempty: torch.Tensor, class_i: torch.Tensor, *,
                    valid: torch.Tensor | None = None,
                    lane_cols: torch.Tensor | None = None) -> torch.Tensor:
        """The summed violation counts -> this rank's part of the output
        (B, M [+ 2]) f32: its class shards' currents (and meters) on its
        rows, zeros elsewhere."""
        rows = self.rows
        fired = (viol == 0) & nonempty.to(torch.bool)[None, :]
        if valid is not None:
            fired &= valid[rows].to(torch.bool)[:, None]
        if lane_cols is not None:
            fired &= lane_cols[rows].to(torch.bool)
        # Class stage: this rank drives its own class shards with their
        # slice of the clause bits; with S sharded the per-shard ADC and
        # digital add is the sum over the model group that follows.
        drv = fired.to(torch.float32)
        ss = self.ss
        i_cls = torch.zeros((drv.shape[0], len(ss), self.M),
                            dtype=torch.float32, device=drv.device)
        for i, lo, k in class_calls(self.n, self.sr, ss):
            i_cls[:, i] = ops.crossbar_mvm(drv[:, lo:lo + k].contiguous(),
                                           class_i[ss[i], :k].contiguous(),
                                           v_read=1.0, cutoff=0.0,
                                           impl=self.impl)
        parts = [i_cls.sum(dim=1)]
        if self.meter:
            if valid is not None:
                i_col = i_col * valid[rows].to(torch.float32)[:, None, None]
            parts += [i_col.sum(dim=(1, 2))[:, None],
                      i_cls.sum(dim=(1, 2))[:, None]]
        out = torch.cat([t if p or self.first else torch.zeros_like(t)
                         for t, p in zip(parts, self.partial)], dim=1)
        if self.batch_sharded:
            full = torch.zeros((self.B, out.shape[1]), dtype=torch.float32,
                               device=out.device)
            full[rows] = out
            out = full
        return out

    def reduce_out(self, out: torch.Tensor) -> None:
        """The per-shard ADC and digital add (and the batch's assembly):
        ``out`` summed in place over the model axis where a part is
        partial, and over the data axes where the batch shards."""
        _all_reduce(out, self.mesh,
                    (("model",) if self.reduce_model else ())
                    + (data_axes(self.mesh) if self.batch_sharded else ()))

    def tail(self, out: torch.Tensor):
        """The summed output -> scores (B, M), and with ``meter`` the
        per-lane clause and class currents (B,)."""
        scores = out[:, :self.M]
        if not self.meter:
            return scores
        return scores, out[:, self.M], out[:, self.M + 1]


def fused_impact_sharded(literals: torch.Tensor,
                         clause_i: torch.Tensor | None,
                         nonempty: torch.Tensor, class_i: torch.Tensor, *,
                         thresh: float, mesh, impl: str = "cuda",
                         valid: torch.Tensor | None = None,
                         meter: bool = False, shard_r: bool = True,
                         shard_s: bool = True, packed=None,
                         packed_tr: int | None = None,
                         lane_cols: torch.Tensor | None = None):
    """Sharded analog inference: literals (B, K) -> class currents (B, M);
    the counterpart of the reference's ``fused_impact_shmap``.

    Same contract as ``ops.fused_impact`` (the normal entry point: it
    calls here when ``shard_plan`` finds a placement).  Every rank of
    ``mesh`` calls with the same full operands on its own device and gets
    the full result.  ``(shard_r, shard_s)`` is the placement: a False
    entry replicates that crossbar on every rank and skips its reduction.
    ``valid`` (B,) bool masks lanes out of the fired bits and the meters.
    With ``meter=True`` also returns the per-lane summed clause / class
    crossbar currents (B,) f32 (``impact.energy.per_lane_read_energy``
    turns them into joules), with the single-device staged path's valid
    masking, so per-request bills sum to the batch meter under every plan.

    ``packed`` (a ``kernels.packing.PackedClause``) swaps the clause
    operand for the 2-bit bitplane layout: the codes shard over the model
    axis like the f32 currents, and each rank dequantizes only its own
    shards.  ``packed_tr`` is the unpacked rows of a shard; ``clause_i``
    must be None in packed mode.

    ``lane_cols`` (B, C*tc) bool is the co-residency tenant mask
    (``kernels.ref.coresident_lane_mask``): ANDed into the fired bits
    after the violation reduction and before the class drive, so a lane's
    foreign columns never reach foreign class rows.

    The body is ``ShardedCall``'s stages with the two all-reduces between
    them.
    """
    if packed is not None:
        if clause_i is not None or packed_tr is None:
            raise ValueError("packed mode takes clause_i=None and the "
                             "unpacked shard rows packed_tr")
        clause_shape = tuple(packed.bits.shape)
    else:
        clause_shape = tuple(clause_i.shape)
    n = clause_shape[1] * clause_shape[3]
    if nonempty.shape != (n,):
        raise ValueError(f"nonempty has shape {tuple(nonempty.shape)}, the "
                         f"clause grid {n} columns")
    call = ShardedCall(*literals.shape, clause_shape, tuple(class_i.shape),
                       thresh=thresh, mesh=mesh, impl=impl, meter=meter,
                       shard_r=shard_r, shard_s=shard_s, packed_tr=packed_tr)
    viol, i_col = call.clause_stage(literals, clause_i, packed)
    call.reduce_viol(viol)
    out = call.class_stage(viol, i_col, nonempty, class_i, valid=valid,
                           lane_cols=lane_cols)
    call.reduce_out(out)
    return call.tail(out)

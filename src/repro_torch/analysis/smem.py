"""The Hopper working set of each kernel a session launches, from the
wrappers' own block constants, and the occupancy those kernels allow.

A block of a Hopper kernel holds its static and dynamic shared memory
and ``threads`` x registers of the register file; a block past 227 KB
(232,448 B) of shared memory does not launch, and the blocks an SM runs
at once are bounded by the SM's 65,536 registers, 2,048 threads and
228 KB of shared memory.  The launch planners assume an occupancy
(``crossbar_mvm.BLOCKS_PER_SM``, ``fused_impact.BLOCKS_PER_SM``,
``PACKED_BLOCKS_PER_SM`` and ``TAIL_BLOCKS_PER_SM``): they size a wave
of blocks by it, so a kernel whose registers or shared memory allow
fewer blocks an SM makes the plan wrong without any error.  This module
prices the shared memory of each kernel from the constants the wrappers
expose (which move when the CUDA sources' do; the tests hold them to the
sources), and ``blocks_per_sm`` reads the registers and shared memory
nvcc reports (``kernels._build.resource_table``) against those limits.
It is the Hopper counterpart of the reference's VMEM budget check.

Register counts are known only once compiled: a ``WorkingSet`` carries
the cap its launch bounds put on them, and the occupancy check takes the
reported count.
"""
from __future__ import annotations

import dataclasses
import importlib

# ``repro_torch.kernels`` re-exports same-named wrapper FUNCTIONS, so the
# modules that hold the block constants are bound by module path.
_class, _clause, _mvm, _fused, _feedback = (
    importlib.import_module(f"repro_torch.kernels.{m}") for m in (
        "class_sum", "clause_eval", "crossbar_mvm", "fused_impact",
        "ta_feedback"))

#: The most shared memory one block may use on an H100 (227 KB, past
#: 48 KB only as dynamic shared memory): the default budget.
DEFAULT_SMEM_BUDGET_BYTES = 232_448

# The limits of one H100 SM (NVIDIA's Hopper tuning guide).
REGISTERS_PER_SM = 65_536
THREADS_PER_SM = 2_048
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED_PER_BLOCK = 1024     # the system's share of each block
MAX_BLOCKS_PER_SM = 32
MAX_REGISTERS = 255
REGISTER_UNIT = 256                # registers are given out per warp in 256s

_F32, _F64, _I32, _U16 = 4, 8, 4, 2


@dataclasses.dataclass(frozen=True)
class WorkingSet:
    """One kernel's block: ``variant`` is the kernel's name in the CUDA
    source (its compiled template variants share it), ``source`` the file
    under ``csrc/``; ``min_blocks`` is its launch bounds' minimum blocks
    an SM, which caps its registers."""
    variant: str
    source: str
    threads: int
    smem_static: int
    smem_dynamic: int = 0
    min_blocks: int = 1

    @property
    def smem_bytes(self) -> int:
        return self.smem_static + self.smem_dynamic

    @property
    def max_registers(self) -> int:
        """Registers a thread at most, under the launch bounds."""
        return min(MAX_REGISTERS,
                   REGISTERS_PER_SM // (self.threads * self.min_blocks))

    @property
    def register_file(self) -> int:
        """Registers of the block at most: ``max_registers`` x threads."""
        return self.max_registers * self.threads


def mvm_working_sets() -> tuple[WorkingSet, ...]:
    """``crossbar_mvm.cu``: the tile kernel (a ring of drive and
    conductance stages), the narrow path (per-warp partial sums) and the
    in-order reduce of a split contraction."""
    tile = 4 * _mvm.STAGES * (_mvm.TILE_B * _mvm.APAD
                              + _mvm.STAGE_K * _mvm.TILE_N)
    narrow = (_F32 * _mvm.NARROW_THREADS // 32 * _mvm.NARROW_MAX_LANES
              * _mvm.NARROW_MAX_N)
    src = "crossbar_mvm.cu"
    return (WorkingSet("mvm_tiles", src, _mvm.THREADS, tile),
            WorkingSet("mvm_narrow", src, _mvm.NARROW_THREADS, narrow),
            WorkingSet("mvm_reduce", src, _mvm.REDUCE_THREADS, 0))


def fused_working_sets(*, packed: bool) -> tuple[WorkingSet, WorkingSet]:
    """``fused_impact.cu``: pass 1 (a ring of f32 drive and cell stages
    and the int8 literals as copied; packed, also the codes as copied)
    and the tail (the fired bits of its lanes, the nonempty bits of the
    columns they share, one f64 clause meter a warp, which the unmetered
    variants leave out, and each warp's f64 class sums of one pass of
    classes and u16 list of fired columns: all variants share the name,
    so the estimate covers the largest), whose launch bounds cap its
    registers for ``TAIL_BLOCKS_PER_SM`` blocks an SM."""
    b, n, k = _fused.F32_TILE
    tile = _fused.STAGES * (_F32 * b * (k + 4) + _F32 * k * n + b * k)
    if packed:
        tile += _fused.STAGES * k // 4 * n
    warps = _fused.TAIL_THREADS // 32
    tail = (2 * _I32 * _fused.TAIL_FIRED_WORDS + _F64 * warps
            + _F64 * warps * _fused.TAIL_CLASSES
            + _U16 * warps * _fused.TAIL_LIST)
    src = "fused_impact.cu"
    return (WorkingSet("packed_tiles" if packed else "impact_tiles", src,
                       _fused.THREADS, tile,
                       min_blocks=_fused.PACKED_BLOCKS_PER_SM if packed
                       else 1),
            WorkingSet("impact_tail", src, _fused.TAIL_THREADS, tail,
                       min_blocks=_fused.TAIL_BLOCKS_PER_SM))


def ta_feedback_working_set() -> WorkingSet:
    """``ta_feedback.cu``: the packed words of a pass and the raw byte
    tiles (then the cells' counts), both static."""
    return WorkingSet("ta_feedback_kernel", "ta_feedback.cu",
                      _feedback.THREADS,
                      _feedback.PACKED_BYTES + _feedback.RAW_BYTES,
                      min_blocks=2)


def digital_working_sets(K: int) -> tuple[WorkingSet, ...]:
    """``digital_cotm.cu`` at K literals: the clause stage of
    ``clause_eval`` and ``fused_cotm`` (static words, a stage's include
    tile dynamic; ``clause_eval.smem_bytes``) and ``class_sum``'s staged
    weights."""
    src = "digital_cotm.cu"
    sets = []
    for name, fused in (("clause_eval_kernel", False),
                        ("fused_cotm_kernel", True)):
        static = _clause.smem_bytes(0, fused)
        sets.append(WorkingSet(name, src, _clause.THREADS, static,
                               _clause.smem_bytes(K, fused) - static))
    sets.append(WorkingSet("class_sum_kernel", src, 32 * _class.CS_LANES,
                           _I32 * _class.CS_CLASSES
                           * (_class.CS_CLAUSES + 4)))
    return tuple(sets)


def all_working_sets() -> tuple[WorkingSet, ...]:
    """Every kernel of the four sources, each at its largest block (the
    clause stage at its widest include tile)."""
    widest = 32 * _clause.STAGE_WORDS
    return (*mvm_working_sets(), *fused_working_sets(packed=False),
            fused_working_sets(packed=True)[0],
            ta_feedback_working_set(), *digital_working_sets(widest))


def planned_blocks() -> dict[str, int]:
    """Blocks an SM each planner sizes its waves by, for the kernels it
    plans (read when called, so that a changed constant shows)."""
    return {"mvm_tiles": _mvm.BLOCKS_PER_SM,
            "mvm_narrow": _mvm.BLOCKS_PER_SM,
            "impact_tiles": _fused.BLOCKS_PER_SM,
            "impact_tail": _fused.TAIL_BLOCKS_PER_SM,
            "packed_tiles": _fused.PACKED_BLOCKS_PER_SM}


def blocks_per_sm(registers: int, threads: int, smem: int) -> int:
    """Blocks of ``threads`` threads, ``registers`` registers a thread and
    ``smem`` bytes of shared memory that one SM runs at once: the least
    that its registers (given out per warp in units of 256), threads and
    shared memory (plus the system's 1 KB a block) allow."""
    warps = -(-threads // 32)
    per_warp = -(-registers * 32 // REGISTER_UNIT) * REGISTER_UNIT
    by_regs = (REGISTERS_PER_SM // (per_warp * warps) if per_warp
               else MAX_BLOCKS_PER_SM)
    return min(by_regs, THREADS_PER_SM // threads,
               SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK),
               MAX_BLOCKS_PER_SM)


def entry_working_sets(session, entry: str,
                       batch: int | None = None) -> tuple[WorkingSet, ...]:
    """The kernels the ``(session, entry)`` pair launches on the
    ``"cuda"`` lowering, following the session's routing
    (``InferenceSession.route``): none on a reference backend; the
    staged compositions (and every co-resident entry) launch
    ``crossbar_mvm`` on the paths its plans take at ``batch`` (128 when
    None), and so do the sharded entries on this rank's lanes and local
    shards; the fused entries pass 1 and the tail; ``ta_feedback`` its
    kernel."""
    if getattr(session.backend, "reference", False):
        return ()
    route = session.route(entry)
    if route == "ta_feedback":
        return (ta_feedback_working_set(),)
    if route in ("staged", "sharded"):
        B = session.local_batch(128 if batch is None else batch)
        tiles, narrow, reduce_ = mvm_working_sets()
        sets = {}
        sms = session.sm_count
        for K, N in session.mvm_calls():
            if B == 0 or N == 0:
                continue
            p = _mvm.plan(B, K, N, sms)
            if p.path == _mvm.NARROW:
                sets["narrow"] = narrow
            else:
                sets["tiles"] = tiles
                if p.splits > 1:
                    sets["reduce"] = reduce_
        return tuple(sets.values())
    return fused_working_sets(packed=session.packed)


def session_working_set(session, entry: str,
                        batch: int | None = None) -> WorkingSet | None:
    """The largest block (by shared memory) of the kernels the
    ``(session, entry)`` pair launches, or None on a reference backend."""
    sets = entry_working_sets(session, entry, batch)
    return max(sets, key=lambda w: w.smem_bytes) if sets else None


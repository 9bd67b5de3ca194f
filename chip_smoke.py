#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card (H100, sm_90a).

    python3 chip_smoke.py    # from the root of a checkout; needs a card

Phases, each of which must pass or the script exits non-zero:

1. environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions, TF32 off;
2. build: every kernel source under ``src/repro_torch/kernels/csrc`` is
   compiled with ``nvcc`` (one process per source, in parallel);
3. kernels: each CUDA kernel against its plain PyTorch version on the same
   card tensors, at the paper serving shape and at ragged and multi-shard
   shapes (the packed kernels on the 2-bit operand packed on the card);
   ``crossbar_mvm`` also at one lane, at the class call (its narrow path)
   and on operands one float past a 16-byte boundary; ``crossbar_mvm``
   and the four fused kernels bit for bit equal to themselves from
   launch to launch; ``fused_impact`` and ``fused_impact_metered`` also
   on literals one byte past an aligned base (the plain-load path); the
   four fused kernels also at 1000 and 300 lanes, where the tail takes 4
   and 2 lanes a block; the packed twins also on codes one and four bytes
   past an aligned base (plain loads, 4-byte copies); ``class_sum`` also
   on signed int8 clauses, past 16 classes, at one clause, on clauses
   one byte off and with no lane, class or clause, bit for bit equal
   from launch to launch;
4. the serving path at paper width (K=1568 literals, n=500 clauses, m=10
   classes, capacity 128): ``build_system`` with device variability,
   sessions for every metering mode, ``predict`` / ``infer_with_report``,
   ``IMPACTEngine`` serving and a Poisson ``replay_trace``, with the
   launch counters showing every kernel ran on that path;
5. the training path at paper width (N=128 states, T=96, s=8): offline
   CoTM training on synthetic digits, programming on ideal and on
   variable devices, the digital kernels against the software CoTM, and
   online training (``OnlineTrainer``) interleaved with ``IMPACTEngine``
   sweeps on one session, with its own launch counters;
6. the compressed serving path on the trained model of phase 5:
   programming on ideal and on variable devices, ``prune_clauses``
   against 1000 training digits, ``packing="2bit"`` sessions for every
   metering mode, exactness gates on ideal devices, an accuracy gate on
   variable devices and ``IMPACTEngine`` serving the packed fused
   session, with its own launch counters;
7. times: the device's busy share while the engine serves (under
   ``torch.profiler``, with each fused pass's device time a call), the
   packed passes' device time a call over a short loop of packed calls,
   then each kernel, its plain version and one PyTorch call for the same
   function, in CUDA-event medians;
8. the co-resident path, with its own launch counters: (a) four members
   of 512 literals, 128 clauses and 10 classes on variable devices share
   the paper's 2048 x 512 clause tile (a 512 x 40 class tile), every
   packing and metering on ``"cuda"``, each lane's fired bits, scores and
   prediction against its member's standalone session, no score off its
   class span, tenant bills summing to the batch meter, the ``"torch"``
   co-resident session on the card, one sweep two ``crossbar_mvm``
   launches, no new preparation while serving; (b) the reference's zoo
   deployment (8 tenants, 44 classes, two SLO classes, capacity 16): a
   parity pass, then a Poisson replay through ``replay_zoo_trace`` that
   sweeps fewer times than 8 per-tenant engines; (c) a standby pool and
   ``rebalance()``; then ``crossbar_mvm`` at both class-call shapes
   against its plain version, with its plan and times;
9. the cost model, the static audit and the adaptive programmer: (a)
   each ``bench_section`` family (``predict`` on ``"torch"`` and
   ``"cuda"``, ``infer_step`` under each metering) and a 2-bit fused
   session calibrated at B = 8 on warm sweeps, every predicted/measured
   ratio at B = 32 and 128 within ``DEFAULT_BAND`` and metered-fused at
   least off, beside the ratios of a unit-weight proxy; (b) ``audit()``
   of every prepared entry of phases 4 and 6 and the trainer's session,
   the SASS of every library (no TF32, f64 only in ``impact_tail``),
   each kernel's registers, shared memory, spills and blocks an SM
   against its planner's ``BLOCKS_PER_SM`` and the shared-memory
   estimate, and every entry swept under ``set_sync_debug_mode("error")``;
   (c) the trained class tile programmed with ``adaptive=True`` on
   variable and ideal devices beside the two-phase schedule, the ideal
   one equal to the CPU run.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
reference package.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Paper serving shape (Table 4 MNIST layout): K literals, n clauses, m
# classes, one row shard (tr = 2048), one column tile (tc = 512), one
# class shard (sr = 2048), a 128-lane slot table.
K, N_CLAUSES, M_CLASSES, CAPACITY = 1568, 500, 10, 128
SEED = 0

# (B, K, n, M, R, tr, C, tc, S, sr): the paper serving layout, then the
# ragged and multi-shard layouts of the reference's fused-kernel tests.
KERNEL_SHAPES = [
    (CAPACITY, K, N_CLAUSES, M_CLASSES, 1, 2048, 1, 512, 1, 2048),
    (4, 100, 50, 10, 1, 128, 1, 64, 1, 64),
    (37, 300, 77, 3, 2, 150, 3, 30, 5, 16),      # R>1, S>1, ragged
    (8, 520, 500, 10, 3, 200, 2, 256, 1, 2048),  # class pad >> clause pad
    (16, 64, 33, 4, 2, 32, 3, 11, 4, 9),         # tiny ragged everything
]

# Tolerances (the reference's own contracts, tests/test_fused_impact.py
# and tests/test_kernels.py):
RTOL_SCORES = 1e-6        # class currents (test_fused_impact.py:66)
RTOL_CLAUSE_METER = 1e-3  # reassociated sum of R*tr*C*tc f32 terms (:137)
RTOL_CLASS_METER = 1e-5   # (:139)
RTOL_COLUMN = 1e-3        # staged column currents over tr rows (:93)
RTOL_MVM = 1e-5           # crossbar_mvm with nonlinearity (test_kernels.py:74)
ATOL_MVM = 1e-12
RTOL_BILLS = 1e-9         # request bills vs batch meter, float64

# Engine throughput: several windows of a few seconds each on the host
# clock, so that the spread between them shows the clock's noise.
ENGINE_WINDOWS, ENGINE_REQUESTS = 3, 65536

# Training path: offline epochs of batch 32 over N_TRAIN digits, held-out
# accuracy on N_HELD_OUT; then ONLINE_UPDATES OnlineTrainer updates of
# ONLINE_BATCH fresh digits, each after an engine sweep over the same
# batch; the digital kernels on DIGITAL_BATCH held-out digits.  A batched
# update sums its samples' TA deltas, so its step grows with the batch:
# at T = 96 from the model after one epoch, batches of 64 do not raise
# held-out accuracy, offline or online, while batches of 16 do
# (``python -m repro_torch.train.update_batch`` measures it), hence
# 16-sample updates over 4096 fresh digits.
N_TRAIN, TRAIN_EPOCHS, N_HELD_OUT = 6000, 4, 1000
ONLINE_UPDATES, ONLINE_BATCH, DIGITAL_BATCH = 256, 16, 256
# The reference's online benchmark updates 64 samples at a time
# (benchmarks/impact_train.py:51): ta_feedback is also checked and timed
# at that doubled batch.
REFERENCE_UPDATE_ROWS = 2 * 64
# The class tile's fine-tune band (``tiles.encode_class_tile``): on ideal
# devices every programmed class cell lies within this many weight
# segments of its target.
FINETUNE_TOL_SEGMENTS = 5

# (B, K, N, M) for the digital kernels: the quickstart's shape, then
# ragged ones (K off every multiple of 32 and 128; 3000 literals take two
# 2048-literal shared-memory stages), then the clause stage's plan edges
# (``clause_eval.plan``): 17 lanes with K one literal past a stage and N
# one column short of a tile, a lane past a 32-lane tile with exactly one
# stage and two tiles of columns, and 512 lanes (256 blocks).
DIGITAL_SHAPES = [(DIGITAL_BATCH, K, N_CLAUSES, M_CLASSES), (5, 70, 33, 4),
                  (37, 300, 77, 3), (9, 130, 129, 10),
                  (100, 3000, N_CLAUSES, M_CLASSES), (17, 2049, 31, 3),
                  (33, 2048, 64, 5), (512, K, N_CLAUSES, M_CLASSES)]
# (2B, K, n) for ta_feedback: the trainer's update, then ragged ones (2B
# off every multiple of 32, several words), then the plan's edges
# (``ta_feedback.plan``): 2B one row past a 128-row pass (two passes),
# exactly one pass with K and n off the 128 x 32 tile, and one cell.
FEEDBACK_SHAPES = [(2 * ONLINE_BATCH, K, N_CLAUSES),
                   (REFERENCE_UPDATE_ROWS, K, N_CLAUSES), (42, 130, 129),
                   (6, 33, 5), (100, 1000, N_CLAUSES), (300, 200, 77),
                   (REFERENCE_UPDATE_ROWS + 1, K, N_CLAUSES), (128, 96, 36),
                   (1, 1, 1)]

# Compressed path: prune against N_CALIBRATION training digits; on
# variable devices the packed session's held-out accuracy must lie within
# PACKED_ACC_TOL of the unpacked session's (the quantized column currents
# sit far from the CSA threshold: about 2.4 uA of leakage on a firing
# column against 4.1 uA).
N_CALIBRATION, PACKED_ACC_TOL = 1000, 0.01
RTOL_PACKED_METERS = 1e-5     # packed vs unpacked meters, ideal devices


class GcTimer:
    """A ``gc.callbacks`` hook: host seconds spent in Python's garbage
    collector while it is installed."""

    def __init__(self):
        self.seconds = 0.0
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0


def fail(msg: str) -> None:
    raise AssertionError(msg)


def allclose(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
             atol: float = 0.0) -> float:
    """Raise unless |got - want| <= atol + rtol * |want| everywhere;
    returns the max absolute error."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        rel = (err / want.abs().clamp_min(1e-300)).max().item()
        fail(f"{name}: {int(bad.sum())} of {bad.numel()} entries outside "
             f"rtol {rtol} (max rel err {rel:.3e})")
    return err.max().item() if err.numel() else 0.0


def exact(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if not torch.equal(got, want):
        n = int((got != want).sum())
        fail(f"{name}: {n} of {got.numel()} entries differ")


def synthetic_system(shape, device, seed=0):
    """Programmed-system tensors in the physical current regime (HCS reads
    ~5 uA, LCS ~3 nA), as in the reference's fused-kernel tests; the
    include density gives each clause a few includes, so that random
    literals make some clauses fire."""
    B, K_, n, M, R, tr, C, tc, S, sr = shape
    rng = np.random.default_rng(seed)
    density = min(0.05, 4.0 / K_)
    include = rng.random((R * tr, C * tc)) < density
    include[K_:, :] = False
    include[:, n:] = False
    g = np.where(include,
                 2.5e-6 * (1 + 0.05 * rng.standard_normal(include.shape)),
                 0.9e-9 * (1 + 0.05 * rng.standard_normal(include.shape)))
    clause_g = g.reshape(R, tr, C, tc).transpose(0, 2, 1, 3)
    wg = rng.uniform(1e-9, 2.5e-6, (S, sr, M))
    wg *= (np.arange(S * sr).reshape(S, sr, 1) < n)
    lit = rng.random((B, K_)) < 0.5

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt)

    from repro_torch.impact.yflash import read_current
    return dict(
        literals=t(lit, torch.int8),
        clause_i=read_current(t(clause_g)).contiguous(),
        nonempty=t(include[:, :C * tc].any(axis=0), torch.bool),
        class_i=read_current(t(wg)).contiguous())


def seeded_params(seed: int = SEED):
    """Untrained CoTM parameters at paper width (K=1568, n=500, m=10), made
    from a seed and the class statistics of synthetic digits: each clause
    includes ~5% of the literals, drawn from those true in >=90% of its
    class's samples (weighted toward literals that separate the class);
    integer weights vote for the clause's class and mildly against the
    rest.  No Tsetlin feedback has run."""
    from repro_torch.convert import params_from_arrays
    from repro_torch.core.booleanize import booleanize
    from repro_torch.core.cotm import CoTMConfig
    from repro_torch.data.synthetic import digits

    n_states, density = 128, 0.05
    x, y = digits(2000, seed=seed)
    lits = booleanize(torch.from_numpy(x)).numpy()
    rng = np.random.default_rng(seed + 1)
    freq = np.stack([lits[y == c].mean(0) for c in range(M_CLASSES)])
    ta = rng.integers(1, n_states + 1, (K, N_CLAUSES))
    w = np.zeros((M_CLASSES, N_CLAUSES), np.int64)
    n_inc = rng.integers(int(density * K * 0.3), int(density * K * 1.7) + 1,
                         N_CLAUSES)
    for j in range(N_CLAUSES):
        c = j % M_CLASSES
        other = np.delete(freq, c, 0).max(0)
        score = np.where(freq[c] >= 0.9,
                         np.clip(freq[c] - other, 0, None) + 0.02, 0.0)
        k = min(int(n_inc[j]), int((score > 0).sum()))
        inc = rng.choice(K, size=k, replace=False, p=score / score.sum())
        ta[inc, j] = rng.integers(n_states + 1, 2 * n_states + 1, inc.size)
        w[c, j] = rng.integers(5, 30)
        w[np.arange(M_CLASSES) != c, j] = -rng.integers(0, 6, M_CLASSES - 1)
    cfg = CoTMConfig(n_literals=K, n_clauses=N_CLAUSES, n_classes=M_CLASSES,
                     n_states=n_states)
    return params_from_arrays(ta, w, device="cpu"), cfg


def digit_literals(n: int, seed: int) -> np.ndarray:
    from repro_torch.core.booleanize import booleanize
    from repro_torch.data.synthetic import digits
    x, _ = digits(n, seed=seed)
    return booleanize(torch.from_numpy(x)).numpy()


# -- phase 3 --------------------------------------------------------------

def check_kernels(device) -> dict[str, float]:
    """Each kernel against its plain version on the same tensors; returns
    the max absolute error per kernel."""
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels import backends, ref
    from repro_torch.kernels.crossbar_mvm import crossbar_mvm
    from repro_torch.kernels.fused_impact import (describe, fused_impact,
                                                  fused_impact_metered)
    cuda_bk = backends.get_backend("cuda")
    torch_bk = backends.get_backend("torch")
    errs = dict(fused_impact=0.0, fused_impact_metered=0.0, crossbar_mvm=0.0)
    for i, shape in enumerate(KERNEL_SHAPES):
        s = synthetic_system(shape, device, seed=i)
        args = (s["literals"], s["clause_i"], s["nonempty"], s["class_i"])
        if s["literals"].is_cuda:
            print(f"fused_impact {shape}: {describe(*args[:2])}")
        e, e_m = check_fused(str(shape), args, TH)
        errs["fused_impact"] = max(errs["fused_impact"], e)
        errs["fused_impact_metered"] = max(errs["fused_impact_metered"], e_m)

        # crossbar_mvm through the staged compositions (CSA bits exact) ...
        f_k, i_k = cuda_bk.impact_clause_bits(*args[:3], thresh=TH)
        f_p, i_p = torch_bk.impact_clause_bits(*args[:3], thresh=TH)
        csa_bits_exact(f"staged clause bits {shape}", f_k, f_p, i_p, TH)
        err_cols = allclose(f"staged column currents {shape}", i_k, i_p,
                            RTOL_COLUMN)
        sc_k, _ = cuda_bk.impact_class_scores(f_p, s["class_i"])
        sc_p, _ = torch_bk.impact_class_scores(f_p, s["class_i"])
        err_cls = allclose(f"staged class scores {shape}", sc_k, sc_p,
                           RTOL_SCORES)
        # ... and on its own, with the Y-Flash nonlinearity switched on.
        rng = np.random.default_rng(100 + i)
        B, Kx, N = shape[0], shape[5], shape[2]
        drive = torch.as_tensor(rng.random((B, Kx)), device=device,
                                dtype=torch.float32)
        g = torch.as_tensor(10.0 ** rng.uniform(-9, -5.6, (Kx, N)),
                            device=device, dtype=torch.float32)
        err_mvm = allclose(f"crossbar_mvm {shape}", crossbar_mvm(drive, g),
                           ref.crossbar_mvm_ref(drive, g), RTOL_MVM, ATOL_MVM)
        errs["crossbar_mvm"] = max(errs["crossbar_mvm"], err_cols, err_cls,
                                   err_mvm)
    errs["crossbar_mvm"] = max(errs["crossbar_mvm"], check_mvm_paths(device))
    e, e_m = check_unaligned_literals(device)
    errs["fused_impact"] = max(errs["fused_impact"], e)
    errs["fused_impact_metered"] = max(errs["fused_impact_metered"], e_m)
    torch.cuda.synchronize()
    return errs


def check_fused(label: str, args: tuple, thresh: float,
                packed_tr: int | None = None) -> tuple[float, float]:
    """``fused_impact`` and ``fused_impact_metered`` (their packed twins
    when ``packed_tr`` is given, on args (literals, bits, levels,
    nonempty, class_i)) against their plain versions: argmax exact,
    scores, clause and class meters at the reference's tolerances; each
    kernel launched twice on the same operands, bit for bit equal.
    Returns the max absolute errors of the two kernels."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_impact import (
        fused_impact, fused_impact_metered, fused_impact_packed,
        fused_impact_packed_metered)
    if packed_tr is None:
        fns = ((fused_impact, ref.fused_impact_ref, {}),
               (fused_impact_metered, ref.fused_impact_metered_ref, {}))
    else:
        kw = dict(tr=packed_tr)
        fns = ((fused_impact_packed, ref.fused_impact_packed_ref, kw),
               (fused_impact_packed_metered,
                ref.fused_impact_packed_metered_ref, kw))
    errs = []
    for fn, plain, kw in fns:
        name = f"{fn.__name__} {label}"
        got = fn(*args, thresh=thresh, **kw)
        again = fn(*args, thresh=thresh, **kw)
        want = plain(*args, thresh=thresh, **kw)
        if isinstance(got, torch.Tensor):
            got, again, want = (got,), (again,), (want,)
        for what, g, a in zip(("scores", "clause meter", "class meter"),
                              got, again):
            exact(f"{name} {what} run to run", g, a)
        exact(f"{name} argmax", got[0].argmax(-1), want[0].argmax(-1))
        err = allclose(f"{name} scores", got[0], want[0], RTOL_SCORES)
        if len(got) == 3:
            err = max(err,
                      allclose(f"{name} clause meter", got[1], want[1],
                               RTOL_CLAUSE_METER),
                      allclose(f"{name} class meter", got[2], want[2],
                               RTOL_CLASS_METER))
        errs.append(err)
    return errs[0], errs[1]


def check_unaligned_literals(device) -> tuple[float, float]:
    """``fused_impact`` and ``fused_impact_metered`` at the paper serving
    shape on literals one byte past an aligned base (a ``[:, 1:]`` slice,
    made contiguous at an odd offset of a larger buffer): the pass-1
    literal loads take their plain-load path.  Returns the max absolute
    errors."""
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels.fused_impact import describe
    s = synthetic_system(KERNEL_SHAPES[0], device, seed=40)
    lit = s["literals"]
    B, K_ = lit.shape
    wide = torch.cat([torch.zeros((B, 1), dtype=torch.int8, device=device),
                      lit], dim=1)
    buf = torch.zeros(B * K_ + 16, dtype=torch.int8, device=device)
    odd = buf[1:1 + B * K_].view(B, K_)
    odd.copy_(wide[:, 1:])
    if odd.data_ptr() % 2 != 1:
        fail("fused_impact unaligned: the literals start on an even byte")
    args = (odd, s["clause_i"], s["nonempty"], s["class_i"])
    errs = check_fused("unaligned literals", args, TH)
    path = describe(*args[:2]) if odd.is_cuda else "plain version"
    print(f"fused_impact unaligned literals {(B, K_)}: {path}; max abs err "
          f"{errs[0]:.3e} / {errs[1]:.3e} (metered)")
    return errs


def mvm_operands(B: int, Kx: int, N: int, device, seed: int,
                 offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """drive (B, Kx) in [0, 1) and conductances (Kx, N) of 1 nS to 2.5 uS
    (some under the 10 nS cutoff of the nonlinearity), each a contiguous
    view ``offset`` floats into a larger buffer."""
    rng = np.random.default_rng(seed)
    d = torch.as_tensor(rng.random(B * Kx + offset), device=device,
                        dtype=torch.float32)[offset:].view(B, Kx)
    g = torch.as_tensor(10.0 ** rng.uniform(-9, -5.6, Kx * N + offset),
                        device=device, dtype=torch.float32)
    g = g[offset:].view(Kx, N)
    return d, g


def check_mvm_paths(device) -> float:
    """crossbar_mvm with the nonlinearity on at the paper clause call with
    one lane, the class call (the narrow path), and the clause call on
    operands one float past a 16-byte boundary (4-byte copies); then two
    launches on the same inputs, which must agree bit for bit.  Returns
    the max absolute error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.crossbar_mvm import crossbar_mvm, describe
    err = 0.0
    for i, (label, B, Kx, N, offset) in enumerate((
            ("one lane", 1, K, 512, 0),
            ("class call", CAPACITY, N_CLAUSES, M_CLASSES, 0),
            ("unaligned", CAPACITY, K, 512, 1))):
        d, g = mvm_operands(B, Kx, N, device, seed=300 + i, offset=offset)
        if offset and (d.data_ptr() % 16 == 0 or g.data_ptr() % 16 == 0):
            fail(f"crossbar_mvm {label}: the operands are 16-byte aligned")
        e = allclose(f"crossbar_mvm {label} {(B, Kx, N)}", crossbar_mvm(d, g),
                     ref.crossbar_mvm_ref(d, g), RTOL_MVM, ATOL_MVM)
        err = max(err, e)
        path = describe(d, g) if d.is_cuda else "plain version"
        print(f"crossbar_mvm {label} {(B, Kx, N)}: {path}; max abs err "
              f"{e:.3e}")
    d, g = mvm_operands(CAPACITY, K, 512, device, seed=303)
    exact("crossbar_mvm run to run", crossbar_mvm(d, g), crossbar_mvm(d, g))
    return err


def csa_bits_exact(name: str, got: torch.Tensor, want: torch.Tensor,
                   i_col: torch.Tensor, thresh: float) -> None:
    """``exact`` for CSA bits (B, C*tc); a flipped bit is reported with
    the margin of its column current (the plain version's, nearest shard)
    to the threshold."""
    if torch.equal(got, want):
        return
    B = i_col.shape[0]
    cur = i_col.reshape(B, i_col.shape[1], -1)             # (B, R, C*tc)
    margin = ((cur - thresh).abs() / thresh).amin(dim=1)   # (B, C*tc)
    bad = (got != want).nonzero().tolist()
    fail(f"{name}: {len(bad)} of {got.numel()} bits differ; (lane, column, "
         f"relative margin to the threshold): "
         + ", ".join(f"({b}, {c}, {margin[b, c].item():.2e})"
                     for b, c in bad[:8]))


def check_packed_kernels(device) -> dict[str, float]:
    """The packed kernels against their plain versions on the same card
    tensors, the clause operand packed on the card (its bits equal to
    the CPU's packing); the staged compositions on the dequantized codes
    give the plain CSA bits exactly.  Returns the max absolute error per
    kernel."""
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels import backends, packing
    from repro_torch.kernels.fused_impact import describe
    cuda_bk = backends.get_backend("cuda")
    torch_bk = backends.get_backend("torch")
    errs = dict(fused_impact_packed=0.0, fused_impact_packed_metered=0.0)
    for i, shape in enumerate(KERNEL_SHAPES):
        s = synthetic_system(shape, device, seed=20 + i)
        tr = shape[5]
        pk = packing.pack_clause_operand(s["clause_i"])
        exact(f"packed bits on the card vs the CPU {shape}", pk.bits.cpu(),
              packing.pack_clause_operand(s["clause_i"].cpu()).bits)
        args = (s["literals"], pk.bits, pk.levels, s["nonempty"],
                s["class_i"])
        if s["literals"].is_cuda:
            print(f"fused_impact_packed {shape}: "
                  f"{describe(s['literals'], pk.bits, tr)}")
        e, e_m = check_fused(str(shape), args, TH, packed_tr=tr)
        errs["fused_impact_packed"] = max(errs["fused_impact_packed"], e)
        errs["fused_impact_packed_metered"] = max(
            errs["fused_impact_packed_metered"], e_m)
        deq = packing.dequant_clause(pk.bits, pk.levels, tr)
        f_k, _ = cuda_bk.impact_clause_bits(s["literals"], deq,
                                            s["nonempty"], thresh=TH)
        f_p, _ = torch_bk.impact_clause_bits(s["literals"], deq,
                                             s["nonempty"], thresh=TH)
        exact(f"packed staged clause bits {shape}", f_k, f_p)
    for k, v in zip(errs, check_unaligned_codes(device)):
        errs[k] = max(errs[k], v)
    torch.cuda.synchronize()
    return errs


def check_unaligned_codes(device) -> tuple[float, float]:
    """``fused_impact_packed`` and ``fused_impact_packed_metered`` at the
    paper serving shape on codes one byte and four bytes past an aligned
    base (contiguous copies at those offsets of a larger buffer): pass 1
    takes its plain code loads and its 4-byte code copies.  Returns the
    max absolute errors."""
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels import packing
    from repro_torch.kernels.fused_impact import code_width, describe
    shape = KERNEL_SHAPES[0]
    tr = shape[5]
    s = synthetic_system(shape, device, seed=41)
    pk = packing.pack_clause_operand(s["clause_i"])
    errs = (0.0, 0.0)
    for offset, width in ((1, 1), (4, 4)):
        buf = torch.zeros(pk.bits.numel() + 32, dtype=torch.uint8,
                          device=device)
        bits = buf[offset:offset + pk.bits.numel()].view(pk.bits.shape)
        bits.copy_(pk.bits)
        if bits.data_ptr() % 16 != offset:
            fail(f"fused_impact_packed codes {offset} byte(s) off: the "
                 f"buffer is not 16-byte aligned")
        args = (s["literals"], bits, pk.levels, s["nonempty"], s["class_i"])
        e = check_fused(f"codes {offset} byte(s) off", args, TH, packed_tr=tr)
        errs = tuple(max(a, b) for a, b in zip(errs, e))
        path = "plain version"
        if bits.is_cuda:
            if code_width(bits) != width:
                fail(f"fused_impact_packed codes {offset} byte(s) off take "
                     f"{code_width(bits)}-byte code copies, not {width}")
            path = describe(s["literals"], bits, tr)
        print(f"fused_impact_packed codes {offset} byte(s) off "
              f"{tuple(bits.shape)}: {path}; max abs err {e[0]:.3e} / "
              f"{e[1]:.3e} (metered)")
    return errs


def check_tail_lanes(device) -> dict[str, float]:
    """The four fused kernels at the batches that give the tail blocks
    of several lanes: the paper layout at the compressed path's
    calibration batch (N_CALIBRATION lanes) and at 300 lanes, and the
    ragged multi-shard layout at both, against their plain versions as
    ``check_fused`` holds them.  On the card the plans must give both 2
    and 4 lanes a tail block.  Returns the max absolute error per
    kernel."""
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels import packing
    from repro_torch.kernels.crossbar_mvm import sm_count
    from repro_torch.kernels.fused_impact import plan
    errs = dict(fused_impact=0.0, fused_impact_metered=0.0,
                fused_impact_packed=0.0, fused_impact_packed_metered=0.0)
    seen = set()
    for i, (B, base) in enumerate(((N_CALIBRATION, 0), (300, 0),
                                   (N_CALIBRATION, 2), (300, 2))):
        shape = (B,) + KERNEL_SHAPES[base][1:]
        _, K_, _, _, R, tr, C, tc, _, _ = shape
        s = synthetic_system(shape, device, seed=60 + i)
        pk = packing.pack_clause_operand(s["clause_i"])
        runs = ((("fused_impact", "fused_impact_metered"), False,
                 (s["literals"], s["clause_i"], s["nonempty"], s["class_i"]),
                 None),
                (("fused_impact_packed", "fused_impact_packed_metered"), True,
                 (s["literals"], pk.bits, pk.levels, s["nonempty"],
                  s["class_i"]), tr))
        for names, packed, args, packed_tr in runs:
            e, e_m = check_fused(str(shape), args, TH, packed_tr=packed_tr)
            errs[names[0]] = max(errs[names[0]], e)
            errs[names[1]] = max(errs[names[1]], e_m)
            if device.type == "cuda":
                p = plan(B, K_, R, C, tr, tc, sm_count(device.index), packed)
                seen.add(p.lanes)
                print(f"{names[0]} tail lanes {shape}: {p.tail_blocks} "
                      f"blocks of {p.lanes} lane(s); max abs err {e:.3e} / "
                      f"{e_m:.3e} (metered)")
    if device.type == "cuda" and not {2, 4} <= seen:
        fail(f"tail lanes: the plans gave {sorted(seen)} lanes a block, "
             f"not both 2 and 4")
    torch.cuda.synchronize()
    return errs


def digital_operands(shape, device, seed=0):
    """Literals (mostly ones, as booleanized digits are), an include
    matrix with a few includes a clause and some empty clauses, nonempty
    and signed weights (N, M), on ``device``."""
    B, K_, N, M = shape
    rng = np.random.default_rng(seed)
    inc = rng.random((K_, N)) < 2.0 / K_
    inc[:, ::7] = False
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return (t(rng.random((B, K_)) < 0.9).to(torch.int8), t(inc),
            t(inc.any(axis=0)), t(rng.integers(-20, 21, (N, M))).to(
                torch.int32))


def feedback_operands(shape, device, seed=0):
    """Random 0/1 operands of ``ta_feedback`` at (2B, K, n)."""
    B2, K_, n = shape
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.random(s) < 0.5, device=device)
    return (t(B2, K_).to(torch.int8), t(B2, n), t(B2, n), t(B2, n),
            t(K_, n).to(torch.int32), t(K_, n).to(torch.int32), t(K_, n))


def max_int_err(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Exact equality (dtype, shape, every element): the max absolute
    error is then 0."""
    if got.dtype != want.dtype:
        fail(f"{name}: dtype {got.dtype} != {want.dtype}")
    exact(name, got, want)
    return 0.0


def check_training_kernels(device) -> dict[str, float]:
    """The kernels of the training path (ta_feedback and the digital CoTM
    family) against their plain versions on the same card tensors, exact,
    at the path's shapes, ragged ones and the plans' edges, each bit for
    bit equal to itself on a second launch; returns the max absolute
    error per kernel."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.class_sum import class_sum
    from repro_torch.kernels.clause_eval import clause_eval
    from repro_torch.kernels.fused_cotm import fused_cotm
    from repro_torch.kernels.ta_feedback import ta_feedback
    errs = dict(ta_feedback=0.0, fused_cotm=0.0, clause_eval=0.0,
                class_sum=0.0)

    def twice(name, fn, want):
        got = fn()
        exact(f"{name} run to run", got, fn())
        return max_int_err(name, got, want)

    for i, shape in enumerate(DIGITAL_SHAPES):
        lit, inc, ne, w = digital_operands(shape, device, seed=i)
        want_f = ref.clause_eval_ref(lit, inc, ne)
        if not 0 < int(want_f.sum()) < want_f.numel():
            fail(f"digital operands {shape}: no clause fires, or all do")
        errs["clause_eval"] = max(
            errs["clause_eval"],
            twice(f"clause_eval fired {shape}",
                  lambda: clause_eval(lit, inc, ne), want_f),
            twice(f"clause_eval viol {shape}",
                  lambda: clause_eval(lit, inc, ne, mode="viol"),
                  ref.clause_viol_ref(lit, inc)))
        cl = want_f.to(torch.int8)
        errs["class_sum"] = max(errs["class_sum"], max_int_err(
            f"class_sum {shape}", class_sum(cl, w),
            ref.class_sum_ref(cl, w)))
        errs["fused_cotm"] = max(errs["fused_cotm"], twice(
            f"fused_cotm {shape}", lambda: fused_cotm(lit, inc, w, ne),
            ref.fused_cotm_ref(lit, inc, w, ne)))
    for i, shape in enumerate(FEEDBACK_SHAPES):
        ops = feedback_operands(shape, device, seed=10 + i)
        errs["ta_feedback"] = max(errs["ta_feedback"], twice(
            f"ta_feedback {shape}", lambda: ta_feedback(*ops),
            ref.ta_feedback_ref(*ops)))
    check_unaligned_training_operands(device)
    torch.cuda.synchronize()
    return errs


def off_base(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``offset`` elements past an
    aligned base (a view into a larger buffer)."""
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[offset:offset + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def check_unaligned_training_operands(device) -> None:
    """``ta_feedback``, ``clause_eval`` and ``fused_cotm`` on operands one
    element or one byte past an aligned base, which take the plain-load
    paths (``ta_feedback.widths``, ``clause_eval.widths``), exact against
    the plain versions and bit for bit equal on a second launch."""
    import importlib
    from repro_torch.kernels import ref
    from repro_torch.kernels.clause_eval import clause_eval
    from repro_torch.kernels.fused_cotm import fused_cotm
    tf = importlib.import_module("repro_torch.kernels.ta_feedback")
    ce = importlib.import_module("repro_torch.kernels.clause_eval")
    shape = (REFERENCE_UPDATE_ROWS, K, N_CLAUSES)
    lit2, fired2, sel, match, hi, lo, include = feedback_operands(
        shape, device, seed=40)
    cases = {"hi and lo one int32 off": (lit2, fired2, sel, match,
                                         off_base(hi, 1), off_base(lo, 1),
                                         include),
             "sel one byte off": (lit2, fired2, off_base(sel, 1), match,
                                  hi, lo, include),
             "literals one byte off": (off_base(lit2, 1), fired2, sel,
                                       match, hi, lo, include)}
    for label, ops in cases.items():
        want = (1, 16) if "literals" not in label else (4, 1)
        got_w = tf.widths(ops[0], (ops[2], ops[3], ops[1], ops[6]),
                          (ops[4], ops[5], ops[4]))
        if got_w != want:
            fail(f"ta_feedback {label}: widths {got_w}, not {want}")
        got = tf.ta_feedback(*ops)
        exact(f"ta_feedback {label} run to run", got, tf.ta_feedback(*ops))
        max_int_err(f"ta_feedback {label}", got, ref.ta_feedback_ref(*ops))
    lit, inc, ne, w = digital_operands(
        (DIGITAL_BATCH, K, N_CLAUSES, M_CLASSES), device, seed=41)
    for label, (l_, i_), want in (
            ("literals one byte off", (off_base(lit, 1), inc), (1, 4)),
            ("include one byte off", (lit, off_base(inc, 1)), (16, 1))):
        if ce.widths(l_, i_) != want:
            fail(f"clause stage {label}: widths {ce.widths(l_, i_)}, not "
                 f"{want}")
        for name, fn, plain in (
                ("clause_eval fired", lambda: clause_eval(l_, i_, ne),
                 ref.clause_eval_ref(l_, i_, ne)),
                ("clause_eval viol",
                 lambda: clause_eval(l_, i_, ne, mode="viol"),
                 ref.clause_viol_ref(l_, i_)),
                ("fused_cotm", lambda: fused_cotm(l_, i_, w, ne),
                 ref.fused_cotm_ref(l_, i_, w, ne))):
            got = fn()
            exact(f"{name} {label} run to run", got, fn())
            max_int_err(f"{name} {label}", got, plain)


# (B, N, M) of class_sum's own checks: the training path's, past one
# 16-class pass (37 classes, two passes and a ragged third), one clause,
# N off every multiple of 4 and past one 512-clause weight stage, and no
# lane, class or clause.
CLASS_SUM_SHAPES = [(DIGITAL_BATCH, N_CLAUSES, M_CLASSES),
                    (DIGITAL_BATCH, N_CLAUSES, 37), (9, 1, M_CLASSES),
                    (37, 77, 3), (13, 1030, 17), (0, N_CLAUSES, M_CLASSES),
                    (5, N_CLAUSES, 0), (7, 0, M_CLASSES)]


def check_class_sum(device) -> float:
    """``class_sum`` on signed int8 clauses (the contract; the paths pass
    0/1) against its plain version, exact, at ``CLASS_SUM_SHAPES`` and
    the digital shapes, on clauses one byte past an aligned base (byte
    loads), bit for bit equal on two launches; one launch a call, none
    where B or M is 0.  Returns the max absolute error (0)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.class_sum import KERNEL, class_sum, clause_width
    shapes = CLASS_SUM_SHAPES + [(B, N, M) for B, _, N, M in DIGITAL_SHAPES]
    rng = np.random.default_rng(SEED + 50)
    for i, (B, N, M) in enumerate(shapes):
        w = torch.as_tensor(rng.integers(-20, 21, (N, M)), device=device,
                            dtype=torch.int32)
        for offset in (0, 1):
            buf = torch.as_tensor(rng.integers(-128, 128, B * N + 16),
                                  device=device, dtype=torch.int8)
            cl = buf[offset:offset + B * N].view(B, N)
            before = KERNEL.launches
            got, again = class_sum(cl, w), class_sum(cl, w)
            launched = KERNEL.launches - before
            label = (f"class_sum {(B, N, M)} signed clauses {offset} "
                     f"byte(s) off")
            max_int_err(label, got, ref.class_sum_ref(cl, w))
            exact(f"{label} run to run", got, again)
            if cl.is_cuda and launched != (2 if B and M else 0):
                fail(f"{label}: {launched} launches for two calls")
            if cl.is_cuda and offset and B * N and clause_width(cl) != 1:
                fail(f"{label}: {clause_width(cl)}-byte clause loads")
    torch.cuda.synchronize()
    return 0.0


# -- phase 4 --------------------------------------------------------------

SERVE_KERNELS = ("fused_impact_f32", "fused_impact_metered_f32",
                 "crossbar_mvm_f32")


def serve_path(device) -> dict:
    """Drive the port's serving path at paper width; returns what phase 5
    times and the launch counts of this run."""
    from repro_torch import kernels
    from repro_torch.core.cotm import clause_outputs, include_mask, predict
    from repro_torch.impact import IMPACTConfig, RuntimeSpec, build_system
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels import backends
    from repro_torch.serve import IMPACTEngine, poisson_arrivals, replay_trace

    params, cfg = seeded_params()
    lits = digit_literals(1024, seed=SEED + 7)
    out: dict = {}

    kernels.reset_launch_counts()
    counts = kernels.launch_counts

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    system = build_system(params, cfg, gen,
                          IMPACTConfig(variability=True, finetune=True),
                          device=device)
    torch.cuda.synchronize()
    out["build_system_s"] = time.perf_counter() - t0
    print(f"build_system (variability, finetune) on the card: "
          f"{out['build_system_s']:.2f} s; unconverged cells: clause "
          f"{system.encode_stats['clause']['n_unconverged']}, class "
          f"{system.encode_stats['weights']['n_unconverged']}")
    sessions = {m: system.compile(RuntimeSpec(
        backend="cuda", metering=m, capacity=CAPACITY, device=str(device)))
                for m in ("off", "fused", "staged")}

    # predict: the fused kernel, on every session.
    before = counts()
    batch = lits[:CAPACITY]
    preds = {m: s.predict(batch).predictions for m, s in sessions.items()}
    moved = counts()
    if moved["fused_impact_f32"] - before["fused_impact_f32"] != 3:
        fail("predict did not launch fused_impact once per session")
    for m in ("fused", "staged"):
        exact(f"predict argmax off vs {m}", preds[m], preds["off"])
    cpu = system.compile(RuntimeSpec(backend="torch", device="cpu"))
    exact("predict on the card vs the torch backend on the CPU",
          preds["off"].cpu(), cpu.predict(batch).predictions)

    # infer_with_report: fused meters vs the staged oracle.
    before = counts()
    rep_f = sessions["fused"].infer_with_report(batch)
    mid = counts()
    rep_s = sessions["staged"].infer_with_report(batch)
    after = counts()
    if mid["fused_impact_metered_f32"] == before["fused_impact_metered_f32"]:
        fail("metering='fused' did not launch fused_impact_metered")
    if after["crossbar_mvm_f32"] - mid["crossbar_mvm_f32"] != 2:
        fail("metering='staged' did not launch crossbar_mvm R+S=2 times")
    exact("infer_with_report argmax fused vs staged", rep_f.predictions,
          rep_s.predictions)
    rf, rs = rep_f.report, rep_s.report
    for name, a, b, rtol in (("clause", rf.clause_energy_j,
                              rs.clause_energy_j, RTOL_CLAUSE_METER),
                             ("class", rf.class_energy_j, rs.class_energy_j,
                              RTOL_CLASS_METER)):
        if not abs(a - b) <= rtol * abs(b):
            fail(f"fused vs staged {name} energy: {a} vs {b}")
    print(f"infer_with_report (B={CAPACITY}): read energy "
          f"{rf.read_energy_j:.6e} J fused, {rs.read_energy_j:.6e} J staged; "
          f"{rf.energy_per_datapoint_j * 1e12:.3f} pJ per datapoint")
    valid = np.arange(CAPACITY) < CAPACITY - 5
    st_f = sessions["fused"].infer_step(batch, valid)
    st_s = sessions["staged"].infer_step(batch, valid)
    invalid = ~torch.as_tensor(valid, device=device)
    exact("infer_step sentinel", st_f.predictions[invalid],
          torch.full((5,), -1, device=device))
    for e in (st_f.e_clause_lanes, st_f.e_class_lanes, st_s.e_clause_lanes,
              st_s.e_class_lanes):
        if bool((e[CAPACITY - 5:] != 0).any()):
            fail("an invalid lane billed non-zero energy")
    allclose("per-lane clause energy fused vs staged", st_f.e_clause_lanes,
             st_s.e_clause_lanes, RTOL_CLAUSE_METER)
    allclose("per-lane class energy fused vs staged", st_f.e_class_lanes,
             st_s.e_class_lanes, RTOL_CLASS_METER)

    # IMPACTEngine: a warm-up burst, then ENGINE_WINDOWS timed windows of
    # ENGINE_REQUESTS requests (a few seconds each on the host clock),
    # through each metering mode.  Each window also reads the share of its
    # wall time spent in sweeps (``BatchStats.latency_s``) and in Python's
    # garbage collector.
    served = {}
    burst = np.tile(lits, (ENGINE_REQUESTS // len(lits), 1))
    gc_timer = GcTimer()
    gc.callbacks.append(gc_timer)
    for m, sess in sessions.items():
        eng = IMPACTEngine(sess, clock=time.perf_counter)
        eng.run(lits[:2 * CAPACITY])
        rps, sweep_ms, shares = [], [], []
        for _ in range(ENGINE_WINDOWS):
            q0 = len(eng.request_records)
            gc0 = gc_timer.seconds
            t0 = time.perf_counter()
            p, stats = eng.run(burst)
            wall = time.perf_counter() - t0
            rps.append(len(p) / wall)
            sweeps = [b.latency_s
                      for b in eng.batch_stats[-stats["batches"]:]]
            sweep_ms.append(1e3 * statistics.median(sweeps))
            shares.append((sum(sweeps) / wall,
                           (gc_timer.seconds - gc0) / wall))
            if m != "off":
                bills = sum(r.e_read_j for r in eng.request_records[q0:])
                meter = stats["energy"].read_energy_j
                if not abs(bills - meter) <= RTOL_BILLS * abs(meter):
                    fail(f"engine {m}: request bills {bills!r} != batch "
                         f"meter {meter!r}")
        served[m] = p
        out[f"engine_{m}"] = dict(rps=statistics.median(rps),
                                  sweep_ms=statistics.median(sweep_ms),
                                  engine=eng)
        print(f"IMPACTEngine continuous, metering={m}: {ENGINE_WINDOWS} "
              f"windows of {len(p)} requests, requests/s end to end "
              + " / ".join(f"{r:.1f}" for r in rps)
              + f" (median {statistics.median(rps):.1f}, spread "
              f"{100 * (max(rps) - min(rps)) / statistics.median(rps):.1f}%)"
              f"; {stats['batches']} sweeps a window, median sweep "
              + " / ".join(f"{t:.4f}" for t in sweep_ms)
              + " ms (host clock); share of wall in sweeps / in the "
              "garbage collector "
              + " / ".join(f"{100 * a:.1f}% {100 * b:.1f}%"
                           for a, b in shares))
    gc.callbacks.remove(gc_timer)
    for m in ("fused", "staged"):
        exact(f"engine predictions off vs {m}", torch.as_tensor(served[m]),
              torch.as_tensor(served["off"]))
    exact("engine predictions vs predict", torch.as_tensor(served["off"][
        :CAPACITY]), preds["off"].cpu())

    eng = IMPACTEngine(sessions["staged"], clock=time.perf_counter)
    arrivals = poisson_arrivals(512, rate_rps=4000.0, seed=SEED)
    rep = replay_trace(eng, lits, arrivals)
    out["replay"] = rep
    if rep["completed"] + rep["shed"] != 512:
        fail(f"replay_trace lost requests: {rep}")
    print(f"replay_trace (Poisson 4000 req/s, 512 requests, staged): "
          f"{rep['samples_per_s']:.1f} requests/s, p50 "
          f"{rep['p50_s'] * 1e3:.3f} ms, p99 {rep['p99_s'] * 1e3:.3f} ms, "
          f"shed {rep['shed']}")
    # The serving path ends here: its launch counts are read before the
    # ideal-device check below adds launches of its own.
    torch.cuda.synchronize()
    out["launches"] = counts()
    for sym in SERVE_KERNELS:
        if out["launches"][sym] == 0:
            fail(f"{sym} was never launched on the serving path")

    # "cuda-metered" serves predict through the metered kernel.
    metered = system.compile(RuntimeSpec(
        backend="cuda-metered", metering="off", device=str(device)))
    before = counts()
    got = metered.predict(batch)
    if counts()["fused_impact_metered_f32"] == \
            before["fused_impact_metered_f32"]:
        fail('"cuda-metered" predict did not launch fused_impact_metered')
    exact('predict "cuda-metered" vs "cuda"', got.predictions, preds["off"])
    allclose('scores "cuda-metered" vs "cuda"', got.scores,
             sessions["off"].predict(batch).scores, RTOL_SCORES)

    # Ideal devices: the analog clause bits are the digital CoTM's.
    ideal = build_system(params, cfg, None,
                         IMPACTConfig(variability=False, finetune=True),
                         device=device)
    lit_t = torch.as_tensor(lits, device=device)
    fired, _ = backends.get_backend("cuda").impact_clause_bits(
        lit_t.to(torch.int8), ideal.clause_i, ideal.nonempty, thresh=TH)
    inc = include_mask(params.ta_state.to(device), cfg.n_states)
    exact("ideal analog clause bits vs digital clause_outputs",
          fired[:, :N_CLAUSES], clause_outputs(lit_t, inc))
    dig = predict(params.to(device), lit_t, cfg)
    ana = ideal.compile(RuntimeSpec(device=str(device))).predict(
        lits).predictions
    share = float((ana == dig).float().mean())
    print(f"ideal devices: analog argmax equals digital on {share:.4f} of "
          f"{len(lits)} lanes; variability system: "
          f"{float((preds['off'].cpu() == dig[:CAPACITY].cpu()).float().mean()):.4f}"
          f" of {CAPACITY}")
    torch.cuda.synchronize()
    out["system"] = system
    out["batch"] = batch
    return out


# -- phase 5 --------------------------------------------------------------

TRAIN_KERNELS = ("ta_feedback_i32", "crossbar_mvm_f32", "fused_impact_f32",
                 "fused_impact_metered_f32", "fused_cotm_i32",
                 "clause_eval_i8", "class_sum_i32")


def train_path(device) -> dict:
    """Drive the port's training path at paper width: offline training,
    programming on ideal and variable devices, the digital kernels, and
    online training interleaved with serving on one session.  Returns
    what the timing phase needs and the launch counts of this run."""
    from repro_torch import kernels
    from repro_torch import quickstart as qs
    from repro_torch.core.cotm import (class_scores, clause_outputs,
                                       forward, include_mask,
                                       violation_counts)
    from repro_torch.core.train import (FeedbackDraws, feedback_masks,
                                        ta_draws)
    from repro_torch.impact import IMPACTConfig, RuntimeSpec, build_system
    from repro_torch.impact.runtime import InferenceSession
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.serve import IMPACTEngine
    from repro_torch.train import OnlineTrainer

    out: dict = {}
    lit_tr, y_tr = qs.digit_data(N_TRAIN, 1, device)
    lit_ho, y_ho = qs.digit_data(N_HELD_OUT, 2, device)
    n_on = ONLINE_UPDATES * ONLINE_BATCH
    lit_on, y_on = qs.digit_data(n_on, 3, device)
    lit_on_np = lit_on.cpu().numpy()
    cfg = qs.paper_config(N_CLAUSES)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()

    # 1. Offline training.
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    init = cfg.init(gen)
    acc0 = qs.accuracy(init, cfg, lit_ho, y_ho)
    print(f"offline training at K={K}, n={N_CLAUSES}, m={M_CLASSES} "
          f"(N={cfg.n_states}, T={cfg.threshold}, s={cfg.specificity}); "
          f"held-out software acc before training {acc0:.4f}")
    history = qs.train(init, cfg, lit_tr, y_tr, gen, TRAIN_EPOCHS,
                       held_out=(lit_ho, y_ho))
    params = history[-1]
    sw_acc = qs.accuracy(params, cfg, lit_ho, y_ho)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    print(f"offline training: {TRAIN_EPOCHS} epochs of {N_TRAIN} digits "
          f"(batch 32) in {out['train_s']:.1f} s; held-out software acc "
          f"{acc0:.4f} -> {sw_acc:.4f}")
    if not sw_acc > acc0:
        fail(f"offline training did not raise held-out accuracy "
             f"({acc0} -> {sw_acc})")

    # 2. Ideal devices: the analog clause bits are exactly the digital
    # CoTM's; the class tile holds each weight within the fine-tune band,
    # so an analog prediction may differ from the digital one only where
    # the digital vote margin is within that band over the fired clauses.
    inc = include_mask(params.ta_state, cfg.n_states)
    ideal = build_system(params, cfg, None, IMPACTConfig(variability=False),
                         device=device)
    if ideal.encode_stats["weights"]["n_unconverged"]:
        fail("ideal devices: class cells outside the fine-tune band")
    sess_ideal = ideal.compile(RuntimeSpec(backend="cuda",
                                           device=str(device)))
    fired, _ = sess_ideal.backend.impact_clause_bits(
        lit_ho.to(torch.int8), ideal.clause_i, ideal.nonempty, thresh=TH)
    dig_fired = clause_outputs(lit_ho, inc)
    exact("ideal devices: analog clause bits vs digital clause_outputs",
          fired[:, :N_CLAUSES], dig_fired)
    ana = sess_ideal.predict(lit_ho).predictions
    _, scores = forward(params, lit_ho, cfg)
    dig = scores.argmax(dim=-1)
    gap = (scores.gather(1, dig[:, None])
           - scores.gather(1, ana[:, None]))[:, 0]
    band = 2 * FINETUNE_TOL_SEGMENTS * dig_fired.sum(dim=1)
    outside = (ana != dig) & (gap > band)
    if bool(outside.any()):
        fail(f"ideal devices: {int(outside.sum())} predictions differ from "
             f"the digital CoTM by more than the fine-tune band")
    n_eq = int((ana == dig).sum())
    print(f"ideal devices: clause bits equal the digital CoTM's on all "
          f"{N_HELD_OUT} held-out digits; predictions equal on {n_eq} of "
          f"{N_HELD_OUT} (the rest within the fine-tune band: digital "
          f"margins {sorted(gap[ana != dig].tolist())[:12]}); hardware acc "
          f"{float((ana == y_ho).double().mean()):.4f}")

    # 3. Variable devices, a fused-metering session, the Table-4 report.
    system = build_system(params, cfg, gen, IMPACTConfig(variability=True),
                          device=device)
    res = system.compile(RuntimeSpec(
        backend="cuda", metering="fused",
        device=str(device))).infer_with_report(lit_ho)
    rep = res.report
    hw_acc = float((res.predictions == y_ho).double().mean())
    pj_cl = rep.clause_energy_j / rep.datapoints * 1e12
    pj_cs = rep.class_energy_j / rep.datapoints * 1e12
    if rep.datapoints != N_HELD_OUT or not (
            0 < pj_cl < float("inf") and 0 < pj_cs < float("inf")):
        fail(f"variable devices: bad report {rep}")
    print(f"variable devices: software acc {sw_acc:.4f}, hardware acc "
          f"{hw_acc:.4f} on {N_HELD_OUT} held-out digits; read energy per "
          f"datapoint clause {pj_cl:.3f} pJ, class {pj_cs:.3f} pJ")
    out.update(sw_acc=sw_acc, hw_acc=hw_acc, pj_clause=pj_cl,
               pj_class=pj_cs)

    # 4. The digital kernels against the software CoTM.
    lk = lit_ho[:DIGITAL_BATCH]
    got = qs.digital_kernels(params, cfg, lk)
    want = class_scores(clause_outputs(lk, inc), params.weights)
    exact("fused_cotm vs class_scores(clause_outputs)", got["fused"], want)
    exact("class_sum(clause_eval) vs class_scores(clause_outputs)",
          got["staged"], want)
    exact("clause_eval fired vs clause_outputs", got["fired"],
          clause_outputs(lk, inc))
    exact("clause_eval viol vs violation_counts", got["viol"],
          violation_counts(lk, inc))
    print(f"digital kernels on {DIGITAL_BATCH} held-out digits: fused_cotm "
          f"and class_sum(clause_eval) equal the software CoTM's scores; "
          f"acc {float((got['fused'].argmax(-1) == y_ho[:DIGITAL_BATCH]).double().mean()):.4f}")

    # 5. Online training while serving, on the model after epoch 1.
    deployed = history[0]
    gen_on = torch.Generator(device=device).manual_seed(SEED + 1)
    system_on = build_system(deployed, cfg, gen_on,
                             IMPACTConfig(variability=True), device=device)
    spec = RuntimeSpec(backend="cuda", metering="fused", capacity=CAPACITY,
                       device=str(device))
    session = system_on.compile(spec)
    out["online_session"] = session
    trainer = OnlineTrainer(session, deployed, cfg, generator=gen_on,
                            variability=True)
    engine = IMPACTEngine(session, clock=time.perf_counter)
    acc_before = trainer.evaluate(lit_ho, y_ho)
    t0 = time.perf_counter()
    for u in range(ONLINE_UPDATES):
        sl = slice(u * ONLINE_BATCH, (u + 1) * ONLINE_BATCH)
        q0 = len(engine.request_records)
        _, stats = engine.run(lit_on_np[sl])
        bills = sum(r.e_read_j for r in engine.request_records[q0:])
        meter = stats["energy"].read_energy_j
        if not abs(bills - meter) <= RTOL_BILLS * abs(meter):
            fail(f"online update {u}: request bills {bills!r} != batch "
                 f"meter {meter!r}")
        trainer.update(lit_on[sl], y_on[sl])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acc_after = trainer.evaluate(lit_ho, y_ho)
    fold = 0.0
    for r in trainer.records:
        fold += r["write_energy_j"]
    if fold != trainer.write_energy_j:
        fail(f"write meter {trainer.write_energy_j!r} != left fold of the "
             f"update bills {fold!r}")
    fresh = InferenceSession(system_on, spec).predict(lit_ho)
    cached = session.predict(lit_ho)
    exact("online: cached session predictions vs a fresh session",
          cached.predictions, fresh.predictions)
    exact("online: cached session scores vs a fresh session",
          cached.scores, fresh.scores)
    recs = trainer.records
    print(f"online training: {ONLINE_UPDATES} updates of {ONLINE_BATCH} "
          f"digits, each after an engine sweep over the same batch, "
          f"{wall:.2f} s; held-out hardware acc {acc_before:.4f} -> "
          f"{acc_after:.4f}; flips {sum(r['n_flips'] for r in recs)}, "
          f"pulses {sum(r['prog_pulses'] + r['erase_pulses'] for r in recs)},"
          f" unconverged {sum(r['n_unconverged'] for r in recs)}, write "
          f"energy {trainer.write_energy_j:.6e} J (left fold equal); the "
          f"cached session serves what a fresh one does")
    if not acc_after > acc_before:
        fail(f"online training did not raise held-out accuracy "
             f"({acc_before} -> {acc_after})")
    out.update(acc_online=(acc_before, acc_after))
    # The training path ends here: its launch counts are read before the
    # timing phase adds launches of its own.
    torch.cuda.synchronize()
    out["launches"] = kernels.launch_counts()
    for sym in TRAIN_KERNELS:
        if out["launches"][sym] == 0:
            fail(f"{sym} was never launched on the training path")

    # Operands for the timing phase, at the path's shapes.
    out["digital_ops"] = (lk.to(torch.int8).contiguous(), inc.contiguous(),
                          inc.any(dim=0),
                          params.weights.T.contiguous().to(torch.int32))
    lb, yb = lit_on[-ONLINE_BATCH:], y_on[-ONLINE_BATCH:]
    inc_t = include_mask(trainer.params.ta_state, cfg.n_states)
    fired_t = clause_outputs(lb, inc_t, training=True)
    draws = FeedbackDraws.sample(gen_on, ONLINE_BATCH, cfg)
    _, _, sel, match, fired2 = feedback_masks(
        fired_t, class_scores(fired_t, trainer.params.weights),
        trainer.params.weights, yb, draws, cfg)
    hi, lo = ta_draws(draws, cfg)
    out["feedback_ops"] = (torch.cat([lb, lb]).to(torch.int8), fired2, sel,
                           match, hi, lo, inc_t)
    out["model"] = (params, cfg)
    out["data"] = (lit_tr, lit_ho, y_ho)
    return out


# -- phase 6 --------------------------------------------------------------

COMPRESSED_KERNELS = ("fused_impact_packed_f32",
                      "fused_impact_packed_metered_f32", "crossbar_mvm_f32")


def compressed_path(device, trained: dict) -> dict:
    """Drive the compressed serving path at paper width on the trained
    model: program, prune against calibration digits, compile packed
    sessions, gate them against the unpacked ones and serve.  Returns
    what the timing phase needs and the launch counts of this run."""
    from repro_torch import kernels
    from repro_torch.impact import IMPACTConfig, RuntimeSpec, build_system
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels import backends, packing
    from repro_torch.serve import IMPACTEngine
    from repro_torch.train import prune_clauses

    params, cfg = trained["model"]
    lit_tr, lit_ho, y_ho = trained["data"]
    lit_cal = lit_tr[:N_CALIBRATION]
    cuda_bk = backends.get_backend("cuda")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out: dict = {}

    def spec(metering, packing_="none", capacity=CAPACITY):
        return RuntimeSpec(backend="cuda", metering=metering,
                           packing=packing_, capacity=capacity,
                           device=str(device))

    t0 = time.perf_counter()
    systems = {
        "ideal": build_system(params, cfg, None,
                              IMPACTConfig(variability=False),
                              device=device),
        "variable": build_system(
            params, cfg, torch.Generator(device=device).manual_seed(SEED + 2),
            IMPACTConfig(variability=True), device=device)}
    torch.cuda.synchronize()
    print(f"compressed path: programmed the trained model on ideal and on "
          f"variable devices in {time.perf_counter() - t0:.2f} s")

    for name, system in systems.items():
        t0 = time.perf_counter()
        pruned, stats = prune_clauses(system, lit_cal)
        torch.cuda.synchronize()
        pj = {}
        for tag, sys_ in (("unpruned", system), ("pruned", pruned)):
            rep = sys_.compile(spec("fused", capacity=None)).infer_with_report(
                lit_cal).report
            pj[tag] = (rep.clause_energy_j / rep.datapoints * 1e12,
                       rep.class_energy_j / rep.datapoints * 1e12)
        print(f"{name} devices: prune_clauses on {N_CALIBRATION} training "
              f"digits in {time.perf_counter() - t0:.2f} s: {stats}; read "
              f"energy per datapoint clause / class "
              f"{pj['unpruned'][0]:.3f} / {pj['unpruned'][1]:.3f} pJ -> "
              f"{pj['pruned'][0]:.3f} / {pj['pruned'][1]:.3f} pJ")
        n_nonempty = int(system._nonempty_eff().sum())
        if stats.n_effective + stats.n_never_fired + stats.n_duplicates != \
                n_nonempty:
            fail(f"{name}: pruning does not account for every column")
        # An erased column draws 0 A instead of its leakage.
        lower = (pj["pruned"][0] < pj["unpruned"][0]
                 if stats.n_effective < n_nonempty
                 else pj["pruned"][0] == pj["unpruned"][0])
        if not lower:
            fail(f"{name}: the clause read energy did not follow the "
                 f"erased columns")

        packed = {m: pruned.compile(spec(m, "2bit"))
                  for m in ("off", "fused", "staged")}
        unpacked = pruned.compile(spec("fused"))
        sess = packed["fused"]
        want = packing.pack_clause_operand(pruned.clause_i)
        exact(f"{name}: session packed bits vs pack_clause_operand",
              sess._packed.bits, want.bits)
        exact(f"{name}: session levels vs pack_clause_operand",
              sess._packed.levels, want.levels)
        tr = pruned.clause_i.shape[2]
        preds = {m: s.predict(lit_cal).predictions
                 for m, s in packed.items()}
        for m in ("fused", "staged"):
            exact(f"{name}: packed predictions off vs {m}", preds[m],
                  preds["off"])
        unpacked_pred = unpacked.predict(lit_cal).predictions
        if name == "ideal":
            # Packing is lossless on ideal devices: every HCS and every LCS
            # cell carries one current, which the levels take exactly.
            exact("ideal: dequantized codes vs the pruned clause currents",
                  packing.dequant_clause(*sess._packed, tr), pruned.clause_i)
            ne = pruned._nonempty_eff()
            lit8 = lit_cal.to(torch.int8)
            exact("ideal: packed vs unpacked clause bits",
                  cuda_bk.impact_clause_bits(
                      lit8, packing.dequant_clause(*sess._packed, tr), ne,
                      thresh=TH)[0],
                  cuda_bk.impact_clause_bits(lit8, pruned.clause_i, ne,
                                             thresh=TH)[0])
            exact("ideal: packed vs unpacked predictions", preds["off"],
                  unpacked_pred)
            exact("ideal: pruned vs unpruned predictions on the calibration "
                  "batch", unpacked_pred,
                  system.compile(spec("off", capacity=None)).predict(
                      lit_cal).predictions)
            for m in ("fused", "staged"):
                r_p = packed[m].infer_with_report(lit_cal).report
                r_u = pruned.compile(spec(m)).infer_with_report(
                    lit_cal).report
                for f in ("clause_energy_j", "class_energy_j"):
                    a, b = getattr(r_p, f), getattr(r_u, f)
                    if not abs(a - b) <= RTOL_PACKED_METERS * abs(b):
                        fail(f"ideal {m}: packed {f} {a!r} vs unpacked "
                             f"{b!r}")
            batch = lit_cal[:CAPACITY]
            valid = np.arange(CAPACITY) < CAPACITY - 3
            a = sess.infer_step(batch, valid)
            b = unpacked.infer_step(batch, valid)
            allclose("ideal: packed vs unpacked clause lane energies",
                     a.e_clause_lanes, b.e_clause_lanes, RTOL_PACKED_METERS)
            allclose("ideal: packed vs unpacked class lane energies",
                     a.e_class_lanes, b.e_class_lanes, RTOL_PACKED_METERS)
            if bool((a.e_clause_lanes[CAPACITY - 3:] != 0).any()):
                fail("ideal: an invalid lane billed non-zero energy")
            print("ideal devices: pruned + packed equals pruned unpacked "
                  f"on the {N_CALIBRATION} calibration digits: clause bits,"
                  f" predictions (and those of the unpruned system), "
                  f"fused and staged meters at rtol {RTOL_PACKED_METERS}; "
                  f"the dequantized codes equal the clause currents")
            continue

        # Variable devices: each cell's current becomes its population's
        # mean; the CSA decisions stay far from the threshold.
        p_ho = packed["off"].predict(lit_ho).predictions
        u_ho = unpacked.predict(lit_ho).predictions
        full = system.compile(spec("off", capacity=None)).predict(
            lit_ho).predictions
        acc = {k: float((v == y_ho).double().mean())
               for k, v in (("packed", p_ho), ("unpacked", u_ho),
                            ("unpruned", full))}
        agree = int((p_ho == u_ho).sum())
        print(f"variable devices: on {N_HELD_OUT} held-out digits the packed"
              f" and unpacked pruned sessions agree on {agree}; accuracy "
              f"packed {acc['packed']:.4f}, unpacked {acc['unpacked']:.4f},"
              f" unpruned unpacked {acc['unpruned']:.4f}")
        if abs(acc["packed"] - acc["unpacked"]) > PACKED_ACC_TOL:
            fail(f"variable devices: packed accuracy {acc['packed']} is "
                 f"more than {PACKED_ACC_TOL} from unpacked "
                 f"{acc['unpacked']}")
        nb_p = sess.input_bytes("infer_step", CAPACITY)
        nb_u = unpacked.input_bytes("infer_step", CAPACITY)
        print(f"input_bytes('infer_step', {CAPACITY}): packed {nb_p} B, "
              f"unpacked {nb_u} B, ratio {nb_u / nb_p:.3f}")
        if not nb_u >= 4 * nb_p:
            fail(f"packing cut the sweep's bytes only {nb_u / nb_p:.2f}x")
        out.update(acc=acc, agree=agree, input_bytes=(nb_p, nb_u),
                   system=pruned, batch=lit_cal[:CAPACITY])

        eng = IMPACTEngine(sess, clock=time.perf_counter)
        burst = np.tile(lit_cal.cpu().numpy(),
                        (-(-ENGINE_REQUESTS // N_CALIBRATION), 1))
        burst = burst[:ENGINE_REQUESTS]
        eng.run(burst[:2 * CAPACITY])
        rps = []
        for _ in range(ENGINE_WINDOWS):
            q0 = len(eng.request_records)
            t0 = time.perf_counter()
            p, st = eng.run(burst)
            rps.append(len(p) / (time.perf_counter() - t0))
            bills = sum(r.e_read_j for r in eng.request_records[q0:])
            meter = st["energy"].read_energy_j
            if not abs(bills - meter) <= RTOL_BILLS * abs(meter):
                fail(f"packed engine: request bills {bills!r} != batch "
                     f"meter {meter!r}")
        exact("packed engine predictions vs predict",
              torch.as_tensor(p[:N_CALIBRATION]), preds["fused"].cpu())
        print(f"IMPACTEngine continuous on the pruned + packed fused session:"
              f" {ENGINE_WINDOWS} windows of {len(p)} requests, requests/s "
              + " / ".join(f"{r:.1f}" for r in rps)
              + f" (median {statistics.median(rps):.1f}); request bills "
              f"equal the batch meter at {RTOL_BILLS}")
    torch.cuda.synchronize()
    out["launches"] = kernels.launch_counts()
    for sym in COMPRESSED_KERNELS:
        if out["launches"][sym] == 0:
            fail(f"{sym} was never launched on the compressed path")
    return out


# -- phase 7 --------------------------------------------------------------

def cuda_ms(fn, iters: int = 30) -> float:
    """Median device time of ``fn`` in ms: per iteration, the stream first
    sleeps so the host can enqueue the events and the work behind it, so
    the event pair brackets device time rather than launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(work: tuple[float, float], int_ops: bool = False,
             ) -> tuple[float, str]:
    """The bound of ``work`` = (operations, bytes) from ``kernels/work.py``
    in ms: f32 operations at the FFMA peak, or 0/1 counts at the int8
    tensor-core peak (``int_ops``)."""
    from repro_torch.kernels import work as wk
    ops, moved = work
    t, by = wk.bound_s(moved, ops, wk.PEAK_INT8_OPS if int_ops
                       else wk.PEAK_F32_FLOPS)
    return t * 1e3, by


def time_kernels(served: dict, errs: dict) -> list[dict]:
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels import ref
    from repro_torch.kernels import work as wk
    from repro_torch.kernels.crossbar_mvm import crossbar_mvm, describe
    from repro_torch.kernels.fused_impact import (fused_impact,
                                                  fused_impact_metered)
    from repro_torch.kernels.fused_impact import describe as fused_path
    system, batch = served["system"], served["batch"]
    dev = system.device
    lits = torch.as_tensor(batch, device=dev).to(torch.int8)
    ci, ne, cls = system.clause_i, system.nonempty, system.class_i
    R, C, tr, tc = ci.shape
    S, sr, M = cls.shape
    B = lits.shape[0]
    args = (lits, ci, ne, cls)

    Kl = lits.shape[1]
    if R != 1 or Kl > tr:
        fail(f"the timed layout must be one row shard, got R={R}, tr={tr}")
    # The work the function needs: the K driven rows of the clause tile
    # (rows past K have no drive) over the columns ``wk.needed_columns``
    # counts.
    live = min(C * tc, S * sr)
    drive = 1.0 - lits.float()                             # (B, K)
    ccur = ci[0, :, :Kl].transpose(0, 1).reshape(Kl, C * tc).contiguous()
    wcur = cls.reshape(S * sr, M)[:live].contiguous()

    # Library yardstick for #1/#2: the two-matmul composition.
    def two_matmuls():
        fired = (torch.matmul(drive, ccur) < TH) & ne
        return torch.matmul(fired[:, :live].float(), wcur)

    needed = wk.needed_columns(ne, ccur.ne(0).any(dim=0))
    print(f"fused_impact at the serving shape {tuple(lits.shape)} x "
          f"{tuple(ci.shape)}: {fused_path(lits, ci)}")
    rows = []
    for name, fn, plain, metered in (
            ("fused_impact", lambda: fused_impact(*args, thresh=TH),
             lambda: ref.fused_impact_ref(*args, thresh=TH), False),
            ("fused_impact_metered",
             lambda: fused_impact_metered(*args, thresh=TH),
             lambda: ref.fused_impact_metered_ref(*args, thresh=TH), True)):
        work = wk.fused_impact(B, Kl, R, tr, C * tc, S * sr, M,
                               metered=metered, needed=needed)
        print(f"{name} work: {work[0]:.0f} flop on {work[1]:.0f} B in and "
              f"out ({needed[metered]} of {C * tc} clause columns x {Kl} "
              f"driven rows, {needed[0]} nonempty class rows)")
        b_ms, b_by = bound_ms(work)
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/fused_impact.cu",
            replaces=("src/repro/kernels/fused_impact.py:58"
                      if name == "fused_impact"
                      else "src/repro/kernels/fused_impact.py:134"),
            ms=cuda_ms(fn), plain_ms=cuda_ms(plain), bound_ms=b_ms,
            bound_by=b_by, library_ms=cuda_ms(two_matmuls)))

    # crossbar_mvm: the R + S calls of one staged sweep at B = 128, at the
    # shapes the staged compositions give them (the driven rows only).
    fired = ref.impact_clause_bits_ref(lits, ci, ne, thresh=TH)[0]
    calls = ((drive.contiguous(), ccur),
             (fired[:, :live].float().contiguous(), wcur))
    works = [wk.crossbar_mvm(*d.shape, g.shape[1]) for d, g in calls]
    b_ms, b_by = bound_ms((sum(w[0] for w in works),
                           sum(w[1] for w in works)))
    eff = [(d, g * 1.0) for d, g in calls]   # cutoff 0: effective = g

    def mvm():
        for d, g in calls:
            crossbar_mvm(d, g, v_read=1.0, cutoff=0.0)

    def mvm_plain():
        for d, g in calls:
            ref.crossbar_mvm_ref(d, g, v_read=1.0, cutoff=0.0)

    def mvm_lib():
        for d, g in eff:
            torch.matmul(d, g)

    for label, (d, g), (_, g_eff) in zip(("clause", "class"), calls, eff):
        c_ms = cuda_ms(lambda d=d, g=g: crossbar_mvm(d, g, v_read=1.0,
                                                     cutoff=0.0))
        c_lib = cuda_ms(lambda d=d, g=g_eff: torch.matmul(d, g))
        c_bound, c_by = bound_ms(wk.crossbar_mvm(*d.shape, g.shape[1]))
        print(f"crossbar_mvm {label} call {tuple(d.shape)}x"
              f"{tuple(g.shape)}: {c_ms:.4f} ms, bound {c_bound:.5f} ms by "
              f"{c_by} ({100 * c_bound / c_ms:.1f}% of it), library "
              f"{c_lib:.4f} ms; {describe(d, g)}")
    print(f"one empty launch (torch.cuda._sleep(1)) under the same timer: "
          f"{cuda_ms(lambda: torch.cuda._sleep(1)):.4f} ms")
    rows.append(dict(
        name="crossbar_mvm", route="cuda",
        source="src/repro_torch/kernels/csrc/crossbar_mvm.cu",
        replaces="src/repro/kernels/crossbar_mvm.py:30",
        ms=cuda_ms(mvm), plain_ms=cuda_ms(mvm_plain), bound_ms=b_ms,
        bound_by=b_by, library_ms=cuda_ms(mvm_lib)))
    symbols = dict(fused_impact="fused_impact_f32",
                   fused_impact_metered="fused_impact_metered_f32",
                   crossbar_mvm="crossbar_mvm_f32")
    for r in rows:
        r["launches"] = served["launches"][symbols[r["name"]]]
        r["max_abs_err"] = errs[r["name"]]
    return [{k: r[k] for k in ROW_KEYS} for r in rows]


def time_packed_kernels(compressed: dict, errs: dict) -> list[dict]:
    """The packed kernels at the compressed path's shape (the pruned
    variable-device system, B = 128): each kernel, its plain version and
    one PyTorch yardstick (dequantize, then the two f32 matmuls and the
    compare), with the bound counted as for fused_impact on the codes of
    the driven rows, over the columns each function needs."""
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels import packing, ref
    from repro_torch.kernels import work as wk
    from repro_torch.kernels.fused_impact import (
        describe, fused_impact_packed, fused_impact_packed_metered)
    system = compressed["system"]
    lits = compressed["batch"].to(torch.int8).contiguous()
    ne, cls = system._nonempty_eff(), system.class_i
    R, C, tr, tc = system.clause_i.shape
    S, sr, M = cls.shape
    B, Kl = lits.shape
    if R != 1 or Kl > tr:
        fail(f"the timed layout must be one row shard, got R={R}, tr={tr}")
    bits, levels = packing.pack_clause_operand(system.clause_i)
    args = (lits, bits, levels, ne, cls)
    print(f"fused_impact_packed at the compressed shape {tuple(lits.shape)}"
          f" x {tuple(bits.shape)}: {describe(lits, bits, tr)}")
    live = min(C * tc, S * sr)
    k4 = packing.packed_rows(Kl)
    drive = 1.0 - lits.float()
    bits_live = bits[:, :, :k4].contiguous()
    wcur = cls.reshape(S * sr, M)[:live].contiguous()

    def dequant_two_matmuls():
        cur = packing.dequant_clause(bits_live, levels, 4 * k4)
        cur = cur[0, :, :Kl].transpose(0, 1).reshape(Kl, C * tc)
        fired = (torch.matmul(drive, cur) < TH) & ne
        return torch.matmul(fired[:, :live].float(), wcur)

    # A column draws current where any of its codes is not DEAD.
    needed = wk.needed_columns(
        ne, bits_live[0].ne(0).any(dim=1).reshape(C * tc))

    rows = []
    for name, sym, fn, plain, metered, repl in (
            ("fused_impact_packed", "fused_impact_packed_f32",
             lambda: fused_impact_packed(*args, thresh=TH, tr=tr),
             lambda: ref.fused_impact_packed_ref(*args, thresh=TH, tr=tr),
             False, "src/repro/kernels/fused_impact.py:280"),
            ("fused_impact_packed_metered", "fused_impact_packed_metered_f32",
             lambda: fused_impact_packed_metered(*args, thresh=TH, tr=tr),
             lambda: ref.fused_impact_packed_metered_ref(*args, thresh=TH,
                                                         tr=tr),
             True, "src/repro/kernels/fused_impact.py:453")):
        work = wk.fused_impact(B, Kl, R, tr, C * tc, S * sr, M,
                               metered=metered, packed=True, needed=needed)
        print(f"{name} work: {work[0]:.0f} flop on {work[1]:.0f} B in and "
              f"out ({needed[metered]} of {C * tc} clause columns x {Kl} "
              f"driven rows, {needed[0]} nonempty class rows)")
        b_ms, b_by = bound_ms(work)
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/fused_impact.cu",
            replaces=repl, launches=compressed["launches"][sym],
            max_abs_err=errs[name], ms=cuda_ms(fn), plain_ms=cuda_ms(plain),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(dequant_two_matmuls)))
    return [{k: r[k] for k in ROW_KEYS} for r in rows]


ROW_KEYS = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")


def time_training_kernels(trained: dict, errs: dict) -> list[dict]:
    """The training path's kernels at its shapes: each kernel, its plain
    version and one PyTorch yardstick (f32 matmuls, exact for these
    counts), with the bound from the bytes and the 0/1 operations at the
    int8 tensor-core rate."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import work as wk
    from repro_torch.kernels.class_sum import class_sum
    from repro_torch.kernels.clause_eval import clause_eval
    from repro_torch.kernels.fused_cotm import fused_cotm
    from repro_torch.kernels.ta_feedback import ta_feedback

    lit, inc, ne, w = trained["digital_ops"]
    B, Kl = lit.shape
    N, M = w.shape
    not_l, inc_f, w_f = 1.0 - lit.float(), inc.float(), w.float()
    cl = ref.clause_eval_ref(lit, inc, ne).to(torch.int8)
    cl_f = cl.float()

    def lib_clause():
        return (torch.matmul(not_l, inc_f) == 0) & ne

    def lib_fused():
        return torch.matmul(lib_clause().float(), w_f)

    def lib_class():
        return torch.matmul(cl_f, w_f)

    fb = trained["feedback_ops"]
    lit2, fired2, sel, match, hi, lo, include = fb
    B2, n = fired2.shape
    lit_t = lit2.float().T
    t1f = (sel & match & fired2).float()
    t2f = (sel & ~match & fired2).float()
    lhs = torch.stack([lit_t, 1.0 - lit_t, 1.0 - lit_t]).contiguous()
    rhs = torch.stack([t1f, t1f, t2f]).contiguous()
    decay = (sel & match & ~fired2).float().sum(dim=0)
    hi_f, lo_f, excl_f = hi.float(), lo.float(), (~include).float()

    def lib_feedback():
        p = torch.bmm(lhs, rhs)
        return (hi_f * p[0] - lo_f * (p[1] + decay)
                + excl_f * p[2]).to(torch.int32)

    table = (
        ("ta_feedback", "ta_feedback_i32", "ta_feedback.cu",
         "src/repro/kernels/fused_impact.py:394",
         lambda: ta_feedback(*fb), lambda: ref.ta_feedback_ref(*fb),
         lib_feedback, wk.ta_feedback(B2, Kl, n)),
        ("fused_cotm", "fused_cotm_i32", "digital_cotm.cu",
         "src/repro/kernels/fused_cotm.py:40",
         lambda: fused_cotm(lit, inc, w, ne),
         lambda: ref.fused_cotm_ref(lit, inc, w, ne), lib_fused,
         wk.fused_cotm(B, Kl, N, M)),
        ("clause_eval", "clause_eval_i8", "digital_cotm.cu",
         "src/repro/kernels/clause_eval.py:40",
         lambda: clause_eval(lit, inc, ne),
         lambda: ref.clause_eval_ref(lit, inc, ne), lib_clause,
         wk.clause_eval(B, Kl, N)),
        ("class_sum", "class_sum_i32", "digital_cotm.cu",
         "src/repro/kernels/class_sum.py:30", lambda: class_sum(cl, w),
         lambda: ref.class_sum_ref(cl, w), lib_class,
         wk.class_sum(B, N, M)),
    )
    ref_fb = feedback_operands((REFERENCE_UPDATE_ROWS, Kl, n), lit.device)
    print(f"training-path kernel shapes: ta_feedback (2B, K, n) = "
          f"({B2}, {Kl}, {n}); digital (B, K, N, M) = ({B}, {Kl}, {N}, {M});"
          f" clause_eval viol mode "
          f"{cuda_ms(lambda: clause_eval(lit, inc, ne, mode='viol')):.4f} "
          f"ms; ta_feedback at 2B = {REFERENCE_UPDATE_ROWS} "
          f"{cuda_ms(lambda: ta_feedback(*ref_fb)):.4f} ms (plain "
          f"{cuda_ms(lambda: ref.ta_feedback_ref(*ref_fb)):.4f} ms)")
    rows = []
    for name, sym, src, repl, fn, plain, lib, work in table:
        b_ms, b_by = bound_ms(work, int_ops=True)
        print(f"{name} work: {work[0]:.0f} 0/1 operations on {work[1]:.0f} "
              f"B")
        rows.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}", replaces=repl,
            launches=trained["launches"][sym], max_abs_err=errs[name],
            ms=cuda_ms(fn), plain_ms=cuda_ms(plain), bound_ms=b_ms,
            bound_by=b_by, library_ms=cuda_ms(lib)))
    return [{k: r[k] for k in ROW_KEYS} for r in rows]


FUSED_PASSES = ("impact_tiles", "packed_tiles", "impact_tail")


def pass_times(prof) -> tuple[dict, dict]:
    """Device microseconds and calls by kernel name of a profile."""
    kern, calls = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kern[e.name] = kern.get(e.name, 0.0) + e.time_range.elapsed_us()
            calls[e.name] = calls.get(e.name, 0) + 1
    return kern, calls


def print_fused_passes(label: str, kern: dict, calls: dict) -> None:
    """Each fused pass's device time a call, from ``pass_times``."""
    for n, t in sorted(kern.items(), key=lambda kv: -kv[1]):
        short = re.sub(r"\(.*", "", n.replace(
            "(anonymous namespace)::", "")).replace("void ", "")
        if short.split("<")[0] in FUSED_PASSES:
            print(f"  {label} pass {short}: {calls[n]} calls, "
                  f"{t / calls[n]:.2f} us a call ({t / 1e3:.3f} ms)")


def profile_engines(served: dict, lits: np.ndarray) -> None:
    """One more burst per metering mode under ``torch.profiler``; prints
    the device's busy share of the burst's wall time, the kernels that
    took it and, for the fused kernels' passes, the device time a
    call."""
    from torch.profiler import ProfilerActivity, profile
    for m in ("off", "fused", "staged"):
        eng = served[f"engine_{m}"]["engine"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.run(lits)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern, calls = pass_times(prof)
        busy = sum(kern.values()) * 1e-6
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
        print(f"profile metering={m}: wall {wall * 1e3:.3f} ms, device busy "
              f"{busy * 1e3:.3f} ms ({100 * busy / wall:.2f}% of wall); top: "
              + "; ".join(f"{n[:60]} {t / 1e3:.3f} ms" for n, t in top))
        print_fused_passes(f"metering={m}", kern, calls)


def profile_packed(compressed: dict, calls: int = 50) -> None:
    """A short loop of ``calls`` calls of each packed kernel at the
    compressed path's shape under ``torch.profiler``, printing each
    pass's device time a call and the call's CUDA-event time, on codes
    the pass copies 4 bytes at a time and on codes one byte off (plain
    loads)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels import packing
    from repro_torch.kernels.fused_impact import (
        describe, fused_impact_packed, fused_impact_packed_metered)
    system = compressed["system"]
    lits = compressed["batch"].to(torch.int8).contiguous()
    bits, levels = packing.pack_clause_operand(system.clause_i)
    odd = torch.zeros(bits.numel() + 16, dtype=torch.uint8,
                      device=bits.device)[1:1 + bits.numel()].view(bits.shape)
    odd.copy_(bits)
    tr = system.clause_i.shape[2]
    for codes in (bits, odd):
        args = (lits, codes, levels, system._nonempty_eff(), system.class_i)
        print(f"packed calls: {describe(lits, codes, tr)}")
        for fn in (fused_impact_packed, fused_impact_packed_metered):
            fn(*args, thresh=TH, tr=tr)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn(*args, thresh=TH, tr=tr)
                torch.cuda.synchronize()
            ms = cuda_ms(lambda: fn(*args, thresh=TH, tr=tr))
            print(f"  {fn.__name__}: {ms:.4f} ms a call")
            print_fused_passes(f"{fn.__name__} x {calls}", *pass_times(prof))


def profile_training(trained: dict, calls: int = 50) -> None:
    """A short loop of ``calls`` calls of ``ta_feedback``, ``clause_eval``
    (both modes) and ``fused_cotm`` at the training path's shapes under
    ``torch.profiler``, printing each device kernel's microseconds a call
    and the call's CUDA-event time, on aligned operands and on operands
    one byte off an aligned base (the plain-load paths: literals and sel
    for ``ta_feedback``; literals, include or both for the clause stage);
    fails unless ``ta_feedback`` and ``clause_eval`` run one device kernel
    a call, ``fused_cotm`` one kernel and the memset of its scores, and
    the wrappers count one launch a call."""
    import importlib
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build
    from repro_torch.kernels.clause_eval import clause_eval
    from repro_torch.kernels.fused_cotm import fused_cotm
    from repro_torch.kernels.ta_feedback import ta_feedback
    tf = importlib.import_module("repro_torch.kernels.ta_feedback")
    ce = importlib.import_module("repro_torch.kernels.clause_eval")
    lit, inc, ne, w = trained["digital_ops"]
    fb = trained["feedback_ops"]
    lit_odd, inc_odd = off_base(lit, 1), off_base(inc, 1)
    fb_odd = (off_base(fb[0], 1), fb[1], off_base(fb[2], 1), *fb[3:])
    got = (tf.widths(fb_odd[0], (fb_odd[2], fb_odd[3], fb_odd[1],
                                 fb_odd[6]), (fb_odd[4], fb_odd[5],
                                              fb_odd[4])),
           ce.widths(lit_odd, inc), ce.widths(lit, inc_odd),
           ce.widths(lit_odd, inc_odd))
    if got != ((1, 1), (1, 4), (16, 1), (1, 1)):
        fail(f"profile_training: plain-load widths {got}")
    cases = (("ta_feedback", "ta_feedback_i32", lambda: ta_feedback(*fb),
              0),
             ("ta_feedback plain loads", "ta_feedback_i32",
              lambda: ta_feedback(*fb_odd), 0),
             ("clause_eval fired", "clause_eval_i8",
              lambda: clause_eval(lit, inc, ne), 0),
             ("clause_eval viol", "clause_eval_i8",
              lambda: clause_eval(lit, inc, ne, mode="viol"), 0),
             ("clause_eval fired, plain literal loads", "clause_eval_i8",
              lambda: clause_eval(lit_odd, inc, ne), 0),
             ("clause_eval fired, plain include loads", "clause_eval_i8",
              lambda: clause_eval(lit, inc_odd, ne), 0),
             ("clause_eval fired, plain loads", "clause_eval_i8",
              lambda: clause_eval(lit_odd, inc_odd, ne), 0),
             ("fused_cotm", "fused_cotm_i32",
              lambda: fused_cotm(lit, inc, w, ne), 1),
             ("fused_cotm plain loads", "fused_cotm_i32",
              lambda: fused_cotm(lit_odd, inc_odd, w, ne), 1))
    for label, sym, fn, memsets in cases:
        fn()
        torch.cuda.synchronize()
        before = _build.launch_counts()[sym]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launched = _build.launch_counts()[sym] - before
        kern, seen = pass_times(prof)
        short = {n: re.sub(r"\(.*", "", n.replace(
            "(anonymous namespace)::", "")).replace("void ", "")
                 for n in kern}
        print(f"profile {label} x {calls}: {cuda_ms(fn):.4f} ms a call; "
              + "; ".join(f"{short[n]} {seen[n]} calls, "
                          f"{kern[n] / seen[n]:.2f} us a call"
                          for n in sorted(kern, key=lambda n: -kern[n])))
        sets = [n for n in kern if "memset" in n.lower()]
        others = [n for n in kern if n not in sets]
        if launched != calls:
            fail(f"{label}: {launched} counted launches for {calls} calls")
        if len(others) != 1 or seen[others[0]] != calls:
            got = [(short[n], seen[n]) for n in others]
            fail(f"{label}: device kernels {got} for {calls} calls, not "
                 f"one a call")
        if sum(seen[n] for n in sets) != memsets * calls:
            fail(f"{label}: {sum(seen[n] for n in sets)} memsets for "
                 f"{calls} calls, not {memsets} a call")


# The redesigned kernels, by their mangled names in nvcc's report.
# -- phase 8 --------------------------------------------------------------

# (a) The paper's clause tile shared by CO_TENANTS members of CO_K
# literals, CO_N clauses and CO_M classes each: 2048 x 512 clauses, a
# 512 x 40 class tile, on variable devices; CO_INVALID_EVERY-th lanes of
# the slot table are free.
CO_TENANTS, CO_K, CO_N, CO_M, CO_INVALID_EVERY = 4, 512, 128, 10, 16
# (b) The reference's zoo deployment (benchmarks/impact_throughput.py:
# multi_tenant_sweep and its call in main): 8 tenants of K = 128, n = 48,
# m = 4 + t % 4 (M_tot = 44), include density 0.08, ideal devices, the
# first two in a "gold" class; capacity 16, staged metering; 320 requests,
# Poisson at 400 requests/s.
ZOO_TENANTS, ZOO_K, ZOO_N, ZOO_DENSITY = 8, 128, 48, 0.08
ZOO_CAPACITY, ZOO_REQUESTS, ZOO_RATE = 16, 320, 400.0
# (c) The same tenants, six resident and a warm pool of two sessions.
ZOO_MAX_RESIDENT, ZOO_STANDBY_POOL = 6, 2
RTOL_CLASS_CALL = 1e-6    # crossbar_mvm's class call against its plain one
CORESIDENT_KERNELS = ("crossbar_mvm_f32",)
# (c) gates its routing on lanes that fire: at least this share of its
# lanes must have a nonzero standalone score.
ZOO_MIN_FIRING_SHARE = 0.9


@contextlib.contextmanager
def path_launches(tally: dict[str, int]):
    """A window of the co-resident path: sets every launch count to 0,
    yields the dict that it fills with the counts read at the window's
    end, and adds them to ``tally``.  Checks, standalone sessions and
    per-tenant engines run outside every window, so ``tally`` holds the
    path's own launches and nothing else."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    got: dict[str, int] = {}
    yield got
    got.update(kernels.launch_counts())
    for k, v in got.items():
        tally[k] = tally.get(k, 0) + v


def member_params(seed: int, K_: int, n: int, m: int, *,
                  density: float | None = None, n_states: int = 128):
    """Untrained CoTM parameters from a seed.  With ``density`` each TA
    includes its literal with that probability (the reference benchmark's
    ``_random_cotm``); without it each clause includes 1 to 6 literals, so
    that on literals ``[x, 1 - x]`` of random features a good share of the
    clauses fire.  Integer weights in [-40, 40)."""
    from repro_torch.convert import params_from_arrays
    from repro_torch.core.cotm import CoTMConfig
    rng = np.random.default_rng(seed)
    if density is not None:
        inc = rng.random((K_, n)) < density
    else:
        inc = np.zeros((K_, n), bool)
        for j in range(n):
            inc[rng.choice(K_, int(rng.integers(1, 7)), replace=False), j] = 1
    ta = np.where(inc, n_states + 1, n_states)
    w = rng.integers(-40, 40, (m, n))
    cfg = CoTMConfig(n_literals=K_, n_clauses=n, n_classes=m,
                     n_states=n_states)
    return params_from_arrays(ta, w, device="cpu"), cfg


def feature_literals(rng, rows: int, K_: int) -> np.ndarray:
    """Literals ``[x, 1 - x]`` of ``K_ // 2`` random binary features."""
    x = rng.random((rows, K_ // 2)) < 0.5
    return np.concatenate([x, ~x], axis=1).astype(np.int8)


def gate_predictions(name: str, got: torch.Tensor, want: torch.Tensor,
                     want_scores: torch.Tensor) -> int:
    """Predictions must equal the standalone session's.  A lane that
    differs is printed with the standalone top-two gap, and fails unless
    the class it predicts scores within RTOL_SCORES of the standalone top
    score (a tie to f32 rounding).  Returns the number of such ties."""
    got, want = got.cpu(), want.cpu()
    bad = (got != want).nonzero().flatten().tolist()
    for b in bad:
        s = want_scores[b].double().cpu()
        top2 = s.topk(min(2, s.numel())).values
        g = int(got[b])
        gap = (float(top2[0] - s[g]) if 0 <= g < s.numel()
               else float("inf"))
        print(f"  {name}: lane {b} predicts {g}, standalone "
              f"{int(want[b])}; standalone top-two gap "
              f"{float(top2[0] - top2[-1]):.3e}, its class {gap:.3e} "
              f"under the top")
        if not gap <= RTOL_SCORES * abs(float(top2[0])):
            fail(f"{name}: lane {b} differs from its standalone session "
                 f"by {gap:.3e}, more than a tie to f32 rounding")
    return len(bad)


def coresident_full_tile(device, tally: dict[str, int]) -> dict:
    """(a) Four members share the paper's clause tile: every packing and
    metering on ``"cuda"`` against each member's standalone session and
    against the ``"torch"`` co-resident session on the card.  The
    co-resident ``"cuda"`` session's calls add their launches to
    ``tally``."""
    from repro_torch.impact import (IMPACTConfig, RuntimeSpec, build_system,
                                    build_coresident)
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels import backends, packing, ref

    t0 = time.perf_counter()
    members = []
    for t in range(CO_TENANTS):
        params, cfg = member_params(SEED + 40 + t, CO_K, CO_N, CO_M)
        gen = torch.Generator(device=device).manual_seed(SEED + 50 + t)
        members.append(build_system(params, cfg, gen,
                                    IMPACTConfig(variability=True),
                                    device=device))
    combined, plan = build_coresident(members)
    torch.cuda.synchronize()
    print(f"co-resident (a): {CO_TENANTS} members of (K, n, m) = ({CO_K}, "
          f"{CO_N}, {CO_M}) on variable devices programmed and packed into "
          f"one ({combined.n_literals} x {combined.n_clauses}) clause tile "
          f"and ({combined.n_clauses} x {combined.n_classes}) class tile in "
          f"{time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(SEED + 60)
    B = CAPACITY
    mids = np.arange(B, dtype=np.int32) % CO_TENANTS
    valid = np.arange(B) % CO_INVALID_EVERY != CO_INVALID_EVERY - 1
    lits = np.ones((B, combined.n_literals), np.int8)
    for b in range(B):
        sp = plan.spans[mids[b]]
        lits[b, sp.lit_lo:sp.lit_hi] = feature_literals(rng, 1, CO_K)[0]
    lanes = [np.flatnonzero(mids == t) for t in range(CO_TENANTS)]
    rows = [lits[idx, sp.lit_lo:sp.lit_hi]
            for idx, sp in zip(lanes, plan.spans)]
    lit_t = torch.as_tensor(lits, device=device)
    mid_t = torch.as_tensor(mids, device=device)
    spans_t = torch.tensor(plan.clause_spans, dtype=torch.int32,
                           device=device)
    valid_t = torch.as_tensor(valid, device=device)
    out = dict(members=members, combined=combined, plan=plan)

    fired_share = {}
    for pk in ("none", "2bit"):
        # The fired bits on each lane's own span, exactly as its member's
        # standalone clause stage fires them; none off its span.
        def clause_operand(bk, system):
            ci = system.clause_i
            if pk == "none":
                return ci
            return packing.dequant_clause(*bk.pack_clause_operand(ci),
                                          ci.shape[2])
        bits = {}
        for name in ("cuda", "torch"):
            bk = backends.get_backend(name)
            fired, _ = bk.impact_clause_bits(
                lit_t, clause_operand(bk, combined), combined.nonempty,
                thresh=TH)
            bits[name] = fired & ref.coresident_lane_mask(
                mid_t, spans_t, combined.n_clauses)
        exact(f"co-resident fired bits cuda vs torch on the card ({pk})",
              bits["cuda"], bits["torch"])
        cuda_bk = backends.get_backend("cuda")
        for t, (idx, sp, m) in enumerate(zip(lanes, plan.spans, members)):
            solo, _ = cuda_bk.impact_clause_bits(
                torch.as_tensor(rows[t], device=device),
                clause_operand(cuda_bk, m), m.nonempty, thresh=TH)
            own = bits["cuda"][torch.as_tensor(idx, device=device)]
            exact(f"tenant {t} fired bits vs its standalone clause stage "
                  f"({pk})", own[:, sp.col_lo:sp.col_hi], solo[:, :CO_N])
            if bool(own[:, :sp.col_lo].any() or own[:, sp.col_hi:].any()):
                fail(f"tenant {t}: a clause fired off its span ({pk})")
        fired_share[pk] = float(bits["cuda"].float().sum(1).mean())
        if pk == "none":
            out["class_drive"] = bits["cuda"].float().contiguous()

        for metering in ("off", "staged", "fused"):
            label = f"packing={pk}, metering={metering}"

            def spec(backend, capacity=B, coresident=plan):
                return RuntimeSpec(backend=backend, metering=metering,
                                   packing=pk, capacity=capacity,
                                   device=str(device), coresident=coresident)
            with path_launches(tally):
                co = combined.compile(spec("cuda"))
                traces = co.trace_count
                pred = co.predict(lits, model_ids=mids)
            with path_launches(tally) as got:
                step = co.infer_step(lits, valid, model_ids=mids)
            moved = {k: v for k, v in got.items() if v}
            if moved != {"crossbar_mvm_f32": 2}:
                fail(f"co-resident infer_step ({label}) launched {moved}, "
                     f"not crossbar_mvm R + S = 2 times")
            # Zero cross-tenant leakage: every score off the lane's own
            # class span is exactly 0.
            own_cls = torch.zeros_like(pred.scores, dtype=torch.bool)
            for b in range(B):
                sp = plan.spans[mids[b]]
                own_cls[b, sp.cls_lo:sp.cls_hi] = True
            if bool((pred.scores[~own_cls] != 0).any()):
                fail(f"co-resident scores leak across tenants ({label})")
            co_t = combined.compile(spec("torch"))
            tp = co_t.predict(lits, model_ids=mids)
            exact(f"co-resident predictions cuda vs torch ({label})",
                  pred.predictions, tp.predictions)
            allclose(f"co-resident scores cuda vs torch ({label})",
                     pred.scores, tp.scores, RTOL_SCORES)
            ties = 0
            for t, (idx, sp, m) in enumerate(zip(lanes, plan.spans,
                                                 members)):
                solo = m.compile(spec("cuda", capacity=None,
                                      coresident=None)).predict(rows[t])
                idx_t = torch.as_tensor(idx, device=device)
                allclose(f"tenant {t} scores vs standalone ({label})",
                         pred.scores[idx_t, sp.cls_lo:sp.cls_hi],
                         solo.scores, RTOL_SCORES)
                ties += gate_predictions(
                    f"tenant {t} predict ({label})",
                    pred.predictions[idx_t], solo.predictions, solo.scores)
                v = valid_t[idx_t]
                ties += gate_predictions(
                    f"tenant {t} infer_step ({label})",
                    step.predictions[idx_t][v], solo.predictions[v],
                    solo.scores[v])
            if bool((step.predictions[~valid_t] != -1).any()):
                fail(f"co-resident infer_step sentinel ({label})")
            e_cl = step.e_clause_lanes.cpu().numpy().astype(np.float64)
            e_cs = step.e_class_lanes.cpu().numpy().astype(np.float64)
            if (e_cl[~valid] != 0).any() or (e_cs[~valid] != 0).any():
                fail(f"an invalid co-resident lane billed energy ({label})")
            meter = e_cl.sum() + e_cs.sum()
            bills = sum(float(e_cl[idx][valid[idx]].sum()
                              + e_cs[idx][valid[idx]].sum())
                        for idx in lanes)
            if metering != "off":
                if not meter > 0 or not (abs(bills - meter)
                                         <= RTOL_BILLS * meter):
                    fail(f"tenant bills {bills!r} != batch meter {meter!r} "
                         f"({label})")
                with path_launches(tally):
                    rep = co.infer_with_report(lits, valid=valid,
                                               model_ids=mids)
                exact(f"infer_with_report vs infer_step ({label})",
                      rep.predictions, step.predictions)
            with path_launches(tally):
                for _ in range(2):
                    co.infer_step(lits, valid, model_ids=mids)
                    co.predict(lits, model_ids=mids)
            if co.trace_count != traces + 1 + (metering != "off"):
                fail(f"co-resident session prepared entries while serving "
                     f"({label}): {traces} -> {co.trace_count}")
            print(f"co-resident (a) {label}: predictions equal the "
                  f"standalone sessions' ({ties} tie(s) to f32 rounding), "
                  f"scores rtol {RTOL_SCORES}, none off the lane's span; "
                  f"tenant bills {bills:.6e} J = batch meter; "
                  f"trace_count {co.trace_count}")
    print(f"co-resident (a): fired clauses a lane, mean "
          + ", ".join(f"{v:.1f} ({k})" for k, v in fired_share.items()))
    return out


def zoo_members(device):
    """The zoo's tenants on ideal devices, and each one's (K, n) include
    mask."""
    from repro_torch.impact import IMPACTConfig, build_system
    systems, includes = [], []
    for t in range(ZOO_TENANTS):
        params, cfg = member_params(SEED + 100 + t, ZOO_K, ZOO_N, 4 + t % 4,
                                    density=ZOO_DENSITY)
        systems.append(build_system(
            params, cfg, None, IMPACTConfig(variability=False,
                                            finetune=False), device=device))
        includes.append(params.ta_state.cpu().numpy() > cfg.n_states)
    return systems, includes


def firing_rows(rng, include: np.ndarray, rows: int) -> np.ndarray:
    """Random literal rows on each of which four to eight random clauses
    of ``include`` (K, n) have every included literal set to 1, so that
    they fire: at include density 0.08 random rows fire almost none.
    With fewer, the class tile's few current levels tie many top
    scores."""
    lits = rng.random((rows, include.shape[0])) < 0.5
    for row in lits:
        for j in rng.choice(include.shape[1], int(rng.integers(4, 9)),
                            replace=False):
            row[include[:, j]] = True
    return lits.astype(np.int8)


def zoo_deployment(device, systems, tally: dict[str, int]) -> dict:
    """(b) The reference's multi-tenant deployment: a parity pass of mixed
    batches against the standalone sessions, then a Poisson replay
    against eight per-tenant engines.  The zoo's calls add their launches
    to ``tally``."""
    from repro_torch.impact import RuntimeSpec
    from repro_torch.serve import (IMPACTEngine, ModelZoo, SLOClass,
                                   latency_percentiles, poisson_arrivals,
                                   replay_trace, replay_zoo_trace)
    gold = SLOClass(name="gold", priority=0, max_wait_s=0.0)
    std = SLOClass(name="standard", priority=1, target_occupancy=0.5,
                   max_wait_s=0.02)
    slo_of = lambda t: gold if t < 2 else std
    spec = RuntimeSpec(backend="cuda", metering="staged", device=str(device))
    with path_launches(tally):
        zoo = ModelZoo.build(
            [(f"t{t}", s, slo_of(t)) for t, s in enumerate(systems)], spec,
            capacity=ZOO_CAPACITY, clock=time.perf_counter)
        zoo.warmup()
    oracle = [s.compile(spec) for s in systems]
    rng = np.random.default_rng(SEED + 70)
    tenant_of = rng.integers(ZOO_TENANTS, size=ZOO_REQUESTS)
    rows = [(rng.random(systems[t].n_literals) < 0.5).astype(np.int8)
            for t in tenant_of]
    want = {}
    for t in range(ZOO_TENANTS):
        idx = np.flatnonzero(tenant_of == t)
        if len(idx):
            preds = oracle[t].predict(np.stack([rows[i] for i in idx]))
            want.update(zip(idx.tolist(), preds.predictions.tolist()))
    with path_launches(tally):
        rid_of = {zoo.submit(f"t{t}", rows[i]): i
                  for i, t in enumerate(tenant_of)}
        done = dict(zoo.drain())
    bad = [rid for rid, p in done.items() if p != want[rid_of[rid]]]
    if len(done) != ZOO_REQUESTS or bad:
        fail(f"zoo parity pass: {len(done)} of {ZOO_REQUESTS} done, "
             f"{len(bad)} differ from the standalone sessions")
    st = zoo.stats()
    bill = sum(v["e_read_j"] for v in st["per_tenant"].values())
    meter = st["energy"].read_energy_j
    if not abs(bill - meter) <= RTOL_BILLS * meter:
        fail(f"zoo: tenant bills {bill!r} != batch meter {meter!r}")

    arrivals = poisson_arrivals(ZOO_REQUESTS, ZOO_RATE, seed=SEED)
    reqs = [(f"t{t}", row) for t, row in zip(tenant_of, rows)]
    sweeps0 = zoo.resident_sweeps + zoo.standby_sweeps
    rec0 = len(zoo.request_records)
    with path_launches(tally):
        rep = replay_zoo_trace(zoo, reqs, arrivals)
    co_sweeps = zoo.resident_sweeps + zoo.standby_sweeps - sweeps0
    if rep["completed"] + rep["shed"] != ZOO_REQUESTS:
        fail(f"replay_zoo_trace lost requests: {rep}")
    slo_lat: dict[str, list[float]] = {}
    for r in zoo.request_records[rec0:]:
        slo_lat.setdefault(slo_of(int(r.tenant[1:])).name, []).append(
            r.latency_s)
    per_slo = {k: latency_percentiles(v) for k, v in sorted(slo_lat.items())}
    engine_sweeps = 0
    for t in range(ZOO_TENANTS):
        idx = np.flatnonzero(tenant_of == t)
        if not len(idx):
            continue
        slo = slo_of(t)
        eng = IMPACTEngine(
            systems[t].compile(RuntimeSpec(
                backend="cuda", metering="staged", capacity=ZOO_CAPACITY,
                device=str(device))),
            max_wait_s=slo.max_wait_s, target_occupancy=slo.target_occupancy,
            clock=time.perf_counter)
        eng.warmup()
        replay_trace(eng, np.stack([rows[i] for i in idx]),
                     arrivals[idx] - arrivals[idx[0]])
        engine_sweeps += len(eng.batch_stats)
    if not co_sweeps < engine_sweeps:
        fail(f"the zoo swept {co_sweeps} times, {ZOO_TENANTS} per-tenant "
             f"engines {engine_sweeps}: co-residency saved no sweep")
    print(f"co-resident (b) zoo, {ZOO_TENANTS} tenants of (K, n) = ({ZOO_K},"
          f" {ZOO_N}), M_tot {zoo.session.system.n_classes}, capacity "
          f"{ZOO_CAPACITY}, staged: parity pass {len(done)} requests equal "
          f"the standalone sessions, tenant bills = batch meter; Poisson "
          f"replay {ZOO_REQUESTS} requests at {ZOO_RATE:.0f} req/s: "
          f"{rep['samples_per_s']:.1f} requests/s, shed {rep['shed']}, "
          + "; ".join(f"{k} p50 {v['p50_s'] * 1e3:.3f} ms p99 "
                      f"{v['p99_s'] * 1e3:.3f} ms (n={v['n']})"
                      for k, v in per_slo.items())
          + f"; sweeps {co_sweeps} co-resident vs {engine_sweeps} for "
          f"{ZOO_TENANTS} per-tenant engines")
    return dict(zoo=zoo, oracle=oracle, rows=rows, tenant_of=tenant_of,
                replay=rep, per_slo=per_slo,
                sweeps=(co_sweeps, engine_sweeps))


def zoo_standby(device, systems, includes, oracle,
                tally: dict[str, int]) -> None:
    """(c) Six resident tenants and a warm pool of two: standby tenants
    are served, the table drains, ``rebalance()`` promotes by traffic
    EWMA, and every prediction still equals the standalone session's
    (``gate_predictions``: the class tile's few current levels make exact
    ties common on these rows).
    Its rows fire clauses (``firing_rows``), so that a lane routed to the
    wrong span or tenant changes its prediction; the zoo's calls add
    their launches to ``tally``."""
    from repro_torch.impact import RuntimeSpec
    from repro_torch.serve import ModelZoo, SLOClass
    with path_launches(tally):
        zoo = ModelZoo.build(
            [(f"t{t}", s, SLOClass(name="standard", max_wait_s=0.0))
             for t, s in enumerate(systems)],
            RuntimeSpec(backend="cuda", metering="staged",
                        device=str(device)),
            capacity=ZOO_CAPACITY, max_resident=ZOO_MAX_RESIDENT,
            standby_pool=ZOO_STANDBY_POOL, clock=time.perf_counter)
    rng = np.random.default_rng(SEED + 80)
    lanes = dict(n=0, scored=0, tied=0, ties=0, classes=set())

    def serve_round(counts: dict[int, int]) -> None:
        batches = []
        for t, n in counts.items():
            rows = firing_rows(rng, includes[t], n)
            solo = oracle[t].predict(rows)
            lanes["n"] += n
            lanes["scored"] += int((solo.scores != 0).any(1).sum())
            top2 = solo.scores.double().topk(2, dim=1).values
            lanes["tied"] += int((top2[:, 0] - top2[:, 1] <= RTOL_SCORES
                                  * top2[:, 0].abs()).sum())
            lanes["classes"].update((t, p) for p in
                                    solo.predictions.tolist())
            batches.append((t, rows, solo))
        rids, got = [], {}
        with path_launches(tally):
            for t, rows, _ in batches:
                rids.append([zoo.submit(f"t{t}", row) for row in rows])
            got.update(zoo.drain())
        if sorted(got) != sorted(r for ids in rids for r in ids):
            fail(f"standby zoo: {len(got)} of {sum(map(len, rids))} "
                 f"requests done")
        for (t, _, solo), ids in zip(batches, rids):
            lanes["ties"] += gate_predictions(
                f"standby zoo tenant t{t}",
                torch.tensor([got[r] for r in ids]), solo.predictions,
                solo.scores)

    standby = [t.tid for t in zoo.tenants if not t.resident]
    serve_round({t: 3 for t in range(ZOO_TENANTS)})
    if zoo.standby_sweeps == 0:
        fail("no standby sweep served the standby tenants")
    # Heavy traffic on the standby tenants, then rebalance: they join the
    # resident set, and the two quietest residents leave it.
    serve_round({int(tid[1:]): 40 for tid in standby})
    if zoo.table.occupancy:
        fail("the table did not drain before rebalance()")
    with path_launches(tally):
        moved = zoo.rebalance()
    if not moved:
        fail("rebalance() did not re-pick the resident set")
    promoted = [t.tid for t in zoo.tenants if t.resident]
    if not set(standby) <= set(promoted):
        fail(f"rebalance kept {standby} in standby: resident {promoted}")
    sweeps = zoo.standby_sweeps
    serve_round({t: 3 for t in range(ZOO_TENANTS)})
    share = lanes["scored"] / lanes["n"]
    if share < ZOO_MIN_FIRING_SHARE:
        fail(f"standby zoo: only {lanes['scored']} of {lanes['n']} lanes "
             f"have a nonzero standalone score; the routing gate needs "
             f"{ZOO_MIN_FIRING_SHARE:.0%}")
    print(f"co-resident (c) standby: {ZOO_MAX_RESIDENT} resident, pool "
          f"{ZOO_STANDBY_POOL}; {standby} served by {sweeps} standby sweeps, "
          f"promoted by rebalance() (resident now {promoted}); predictions "
          f"equal the standalone sessions before and after "
          f"({zoo.standby_sweeps - sweeps} standby sweeps since) on "
          f"{lanes['n']} lanes ({lanes['tied']} with a standalone top-two "
          f"tie, {lanes['ties']} broken otherwise by the zoo), "
          f"{lanes['scored']} with a nonzero score, "
          f"{len(lanes['classes'])} distinct (tenant, class) predictions")


def class_call_rows(full: dict, zoo: dict, launches: int) -> list[dict]:
    """``crossbar_mvm`` at the co-resident class calls, (128, 512, 40) of
    (a) and (16, 384, 44) of (b), against its plain version on the card
    (rtol 1e-6, and bit for bit from launch to launch) on the path's fired
    bits and on dense random bits, with its plan, its time, the plain
    version's, the library's (``torch.matmul`` on the conductances with
    the nonlinearity applied) and its bound, on the path's operands."""
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels import backends, ref
    from repro_torch.kernels import work as wk
    from repro_torch.kernels.crossbar_mvm import crossbar_mvm, describe
    z = zoo["zoo"]
    zsys, zplan = z.session.system, z.plan
    dev = zsys.device
    rng = np.random.default_rng(SEED + 90)
    mids = np.arange(ZOO_CAPACITY, dtype=np.int32) % zplan.n_tenants
    lits = np.ones((ZOO_CAPACITY, zsys.n_literals), np.int8)
    for b, t in enumerate(mids):
        sp = zplan.spans[t]
        lits[b, sp.lit_lo:sp.lit_hi] = rng.random(sp.lit_hi - sp.lit_lo) < 0.5
    fired, _ = backends.get_backend("cuda").impact_clause_bits(
        torch.as_tensor(lits, device=dev), zsys.clause_i, zsys.nonempty,
        thresh=TH)
    fired &= ref.coresident_lane_mask(
        torch.as_tensor(mids, device=dev),
        torch.tensor(zplan.clause_spans, dtype=torch.int32, device=dev),
        zsys.n_clauses)
    calls = [(full["class_drive"], full["combined"].class_i[0]),
             (fired.float().contiguous(), zsys.class_i[0].contiguous())]
    mvm = lambda d, g: crossbar_mvm(d, g, v_read=1.0, cutoff=0.0)
    plain = lambda d, g: ref.crossbar_mvm_ref(d, g, v_read=1.0, cutoff=0.0)
    rows = []
    for d, g in calls:
        shape = (*d.shape, g.shape[1])
        dense = (torch.rand(d.shape, device=dev) < 0.5).float()
        err = 0.0
        for label, x in (("fired bits", d), ("dense bits", dense)):
            a = mvm(x, g)
            exact(f"crossbar_mvm class call {shape} on {label} run to run",
                  a, mvm(x, g))
            err = max(err, allclose(
                f"crossbar_mvm class call {shape} on {label} vs plain", a,
                plain(x, g), RTOL_CLASS_CALL))
        # The library yardstick applies the nonlinearity (cutoff 0: none
        # of the conductances is below it) and multiplies.
        g_eff = lambda g=g: g * torch.where(g < 0.0, 1.5, 1.0)
        b_ms, b_by = bound_ms(wk.crossbar_mvm(*d.shape, g.shape[1]))
        row = dict(shape=shape, max_abs_err=err, launches=launches,
                   ms=cuda_ms(lambda: mvm(d, g)),
                   plain_ms=cuda_ms(lambda: plain(d, g)),
                   library_ms=cuda_ms(lambda: torch.matmul(d, g_eff())),
                   bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        print(f"crossbar_mvm co-resident class call {shape} "
              f"({int(d.sum())} fired bits): {row['ms']:.4f} ms (plain "
              f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}, "
              f"bound {b_ms:.6f} ms by {b_by}), max abs err {err:.3e}, "
              f"bitwise run to run; {launches} crossbar_mvm launches on the "
              f"co-resident path; {describe(d, g)}")
    return rows


def coresident_path(device) -> dict:
    """Phase 8: co-residency and the multi-tenant zoo at full tile width,
    riding ``crossbar_mvm``.  Each deployment's launch counts are read in
    windows around the co-resident path's own calls (``path_launches``),
    so checks, standalone sessions and per-tenant engines add none, and
    before the class calls are checked and timed."""
    tallies: dict[str, dict[str, int]] = {"a": {}, "b": {}, "c": {}}
    full = coresident_full_tile(device, tallies["a"])
    systems, includes = zoo_members(device)
    zoo = zoo_deployment(device, systems, tallies["b"])
    zoo_standby(device, systems, includes, zoo["oracle"], tallies["c"])
    launches: dict[str, int] = {}
    for name, tally in tallies.items():
        for sym in CORESIDENT_KERNELS:
            if tally.get(sym, 0) == 0:
                fail(f"{sym} was never launched on the co-resident path's "
                     f"deployment ({name})")
        for k, v in tally.items():
            launches[k] = launches.get(k, 0) + v
    print("co-resident path launches: "
          + "; ".join(f"({name}) " + ", ".join(
              f"{k} {v}" for k, v in tally.items() if v)
              for name, tally in tallies.items())
          + "; in all " + ", ".join(f"{k} {v}" for k, v in launches.items()
                                    if v))
    rows = class_call_rows(full, zoo, launches["crossbar_mvm_f32"])
    return dict(launches=launches, class_calls=rows, zoo=zoo)


# -- phase 9 --------------------------------------------------------------

COST_BATCHES = (8, 32, 128)    # calibrated at the first
COST_SWEEPS = 200              # timed sweeps a (session, batch)


def host_sweep_s(fn, sweeps: int = COST_SWEEPS) -> float:
    """Median host wall of ``fn`` (a warm sweep) followed by a
    synchronize, in seconds."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(sweeps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def cost_model_phase(system, card: str) -> dict:
    """(a) The cost model on the card: the reference's ``bench_section``
    families (``predict`` on ``"torch"`` and ``"cuda"``, ``infer_step``
    on ``"cuda"`` under each metering) plus ``infer_step`` of a
    ``packing="2bit"`` fused session, each calibrated at B = 8 on the
    median host wall of warm synchronized sweeps and predicting B = 32
    and 128; gates: every predicted/measured ratio within the band,
    metered-fused raw cost at least off's at every batch.  Also the
    ratios a unit-weight flops + bytes proxy would give from the same
    counts (printed, not a model)."""
    from repro_torch.impact import RuntimeSpec, SweepCostModel
    from repro_torch.impact.costmodel import DEFAULT_BAND, bench_section
    dev = str(system.device)
    lits = digit_literals(max(COST_BATCHES), seed=SEED + 11)
    valid = np.ones(max(COST_BATCHES), bool)
    lits_dev = torch.as_tensor(lits, device=system.device)
    valid_dev = torch.as_tensor(valid, device=system.device)
    specs = {f"predict/{b}": (RuntimeSpec(backend=b, metering="off",
                                          device=dev), "predict")
             for b in ("torch", "cuda")}
    specs.update({f"infer_step/cuda-{m}": (RuntimeSpec(
        backend="cuda", metering=m, device=dev), "infer_step")
        for m in ("off", "fused", "staged")})
    specs["infer_step/cuda-fused-2bit"] = (RuntimeSpec(
        backend="cuda", metering="fused", packing="2bit", device=dev),
        "infer_step")
    measured: dict[str, dict[int, float]] = {}
    for family, (spec, entry) in specs.items():
        sess = system.compile(spec)
        measured[family] = {}
        for B in COST_BATCHES:
            if entry == "predict":
                host = lambda: sess.predict(lits[:B])
                dev_fn = lambda: sess.predict(lits_dev[:B])
            else:
                host = lambda: sess.infer_step(lits[:B], valid[:B])
                dev_fn = lambda: sess.infer_step(lits_dev[:B], valid_dev[:B])
            measured[family][B] = host_sweep_s(host)
            print(f"cost model {family} B={B}: host wall "
                  f"{measured[family][B] * 1e3:.4f} ms a sweep (median of "
                  f"{COST_SWEEPS}), device time {cuda_ms(dev_fn):.4f} ms "
                  f"(CUDA events), {card}")
    bench = dict(
        results={f"{b}_b{B}": dict(us_per_batch=measured[f"predict/{b}"][B]
                                   * 1e6) for b in ("torch", "cuda")
                 for B in COST_BATCHES},
        metered=dict(results={
            f"metered_{m}_b{B}": dict(
                us_per_batch=measured[f"infer_step/cuda-{m}"][B] * 1e6)
            for m in ("off", "fused", "staged") for B in COST_BATCHES}))
    sec = bench_section(system, bench, batch_sizes=COST_BATCHES)
    packed = SweepCostModel(system.compile(
        specs["infer_step/cuda-fused-2bit"][0]))
    packed.calibrate(COST_BATCHES[0],
                     measured["infer_step/cuda-fused-2bit"][COST_BATCHES[0]])
    for B in COST_BATCHES:
        pred = packed.predict_s(B)
        sec["entries"][f"infer_step/cuda-fused-2bit_b{B}"] = dict(
            predicted_s=pred,
            measured_s=measured["infer_step/cuda-fused-2bit"][B],
            ratio_pred_over_meas=pred
            / measured["infer_step/cuda-fused-2bit"][B])
    lo, hi = DEFAULT_BAND
    for key, e in sec["entries"].items():
        family, B = key.rsplit("_b", 1)
        spec, entry = specs[family]
        est = SweepCostModel(system.compile(spec), entry).estimate(int(B))
        ref = SweepCostModel(system.compile(spec), entry).estimate(
            COST_BATCHES[0])
        unit = (measured[family][COST_BATCHES[0]]
                * (est.flops + est.bytes_accessed)
                / (ref.flops + ref.bytes_accessed) / measured[family][int(B)])
        e["unit_weight_ratio"] = unit
        print(f"cost model {key}: predicted / measured "
              f"{e['ratio_pred_over_meas']:.3f} ({e['predicted_s'] * 1e3:.4f}"
              f" / {e['measured_s'] * 1e3:.4f} ms; {est.launches:.0f} "
              f"launches, bound {est.bound_s * 1e6:.3f} us, {est.flops:.0f} "
              f"flop, {est.bytes_accessed:.0f} B); a unit-weight flops + "
              f"bytes proxy would give {unit:.3f}")
        if not lo < e["ratio_pred_over_meas"] < hi:
            fail(f"cost model {key}: predicted / measured "
                 f"{e['ratio_pred_over_meas']:.3f} outside {DEFAULT_BAND}")
    for key, o in sec["orderings"].items():
        print(f"cost model ordering {key}: raw cost ratio "
              f"{o['raw_cost_ratio']:.4f}")
        if o["raw_cost_ratio"] < o.get("must_be_at_least", 0.0):
            fail(f"cost model ordering {key} fell below 1: "
                 f"{o['raw_cost_ratio']}")
    return sec


def audit_phase(sessions, card: str) -> dict:
    """(b) The static audit on the card: ``audit()`` of every prepared
    entry of ``sessions`` (on the card: with each kernel's occupancy and
    its library's SASS); the SASS of every library (no TF32 anywhere, f64
    arithmetic only in the kernels ``ir_audit.F64_REDUCTIONS`` declares);
    each compiled kernel's registers, shared memory, spills and blocks an
    SM against its planner's assumption and ``analysis.smem``'s estimate;
    and each prepared entry swept once on zeros under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync)."""
    from repro_torch.analysis import ir_audit, smem
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    audited = 0
    for sess in sessions:
        report = sess.audit()
        audited += len(report.fingerprints)
        if not report.ok:
            fail(f"audit of {sess!r}: "
                 + "; ".join(str(f) for f in report.findings))
        if sess.device.type != "cuda":
            continue
        for e, b in sess.compiled_shapes():
            ins = sess.zero_inputs(e, b)
            fn = sess.entry_fn(e)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn(*ins)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"audit: {audited} prepared entries of {len(sessions)} sessions "
          f"ok (precision, host I/O, working set, occupancy, SASS); each "
          f"card entry swept once under sync debug mode 'error' "
          f"({time.perf_counter() - t0:.1f} s)")
    tables = {src: _build.resource_table(src) for src in _build.SOURCES}
    f64 = {}
    for src in _build.SOURCES:
        text = _build.sass(src)
        bad = ir_audit.scan_sass(text, source=src)
        if bad:
            fail("SASS: " + "; ".join(str(f) for f in bad))
        f64[src] = ir_audit.f64_kernels(text)
    if {k.split("<")[0] for v in f64.values() for k in v} != set(
            ir_audit.F64_REDUCTIONS):
        fail(f"f64 arithmetic in {f64}, declared: "
             f"{ir_audit.F64_REDUCTIONS}")
    print(f"SASS ({_build.cuobjdump()} -sass): no TF32 instruction in "
          f"{len(_build.SOURCES)} libraries; f64 arithmetic only in "
          + ", ".join(k for v in f64.values() for k in v))
    sets = smem.all_working_sets()
    bad = ir_audit.resource_findings(sets, tables, entry="all kernels")
    planned = smem.planned_blocks()
    rows = []
    for ws in sets:
        for name, r in sorted(tables[ws.source].items()):
            if name.split("<")[0] != ws.variant:
                continue
            blocks = smem.blocks_per_sm(r.registers, ws.threads,
                                        r.smem + ws.smem_dynamic)
            rows.append(dict(kernel=name, registers=r.registers,
                             smem=r.smem, spills=r.spill_stores
                             + r.spill_loads, blocks_per_sm=blocks,
                             planned=planned.get(ws.variant),
                             estimate=ws.smem_static))
            print(f"  {ws.source} {name}: {r.registers} registers x "
                  f"{ws.threads} threads, {r.smem} B static shared memory "
                  f"(estimate {ws.smem_static} B"
                  + (f", + {ws.smem_dynamic} B dynamic" if ws.smem_dynamic
                     else "")
                  + f"), spills {r.spill_stores} / {r.spill_loads} B, "
                  f"{blocks} blocks an SM"
                  + (f" (planned {planned[ws.variant]})"
                     if ws.variant in planned else ""))
    if bad:
        fail("occupancy / shared memory: "
             + "; ".join(str(f) for f in bad))
    print(f"occupancy: every planner's BLOCKS_PER_SM fits its kernels' "
          f"reported registers and shared memory; every estimate covers "
          f"the reported shared memory; {card}")
    return dict(kernels=rows, f64=f64)


def adaptive_phase(trained: dict, device, card: str) -> dict:
    """(c) ``tune_adaptive`` on the card: phase 5's trained class tile
    programmed with ``adaptive=True`` on variable and on ideal devices,
    beside the fixed two-phase schedule on the same generator seed; gate:
    on ideal devices the card's conductances and pulse counts equal the
    port's own CPU run (rtol 1e-6, as ``tests/test_torch_adaptive.py``)."""
    from repro_torch.core.cotm import to_unipolar
    from repro_torch.impact.tiles import encode_class_tile, weight_targets
    params, _ = trained["model"]
    w = to_unipolar(params.weights)[0].T.contiguous()            # (n, m)
    target = weight_targets(w, int(w.max()))
    out = {}
    for label, variability in (("variable", True), ("ideal", False)):
        for schedule, adaptive in (("two-phase", False),
                                   ("adaptive", True)):
            gen = (torch.Generator(device=device).manual_seed(SEED + 21)
                   if variability else None)
            t0 = time.perf_counter()
            tile, st = encode_class_tile(w, gen, variability=variability,
                                         adaptive=adaptive)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            pulses = sum(int(st[k].sum()) for k in (
                "pretune_prog", "pretune_erase", "finetune_prog",
                "finetune_erase") if k in st)
            err = float(((tile.g - target).abs().mean()
                         / st["segment_size"]))
            out[(label, schedule)] = dict(tile=tile, stats=st, pulses=pulses)
            print(f"class tile {tuple(w.shape)} on {label} devices, "
                  f"{schedule}: {pulses} pulses ({pulses / w.numel():.2f} a "
                  f"cell), {st['n_unconverged']} unconverged, mean |G - "
                  f"target| {err:.3f} segments, {secs:.2f} s host wall; "
                  f"{card}")
    tile, st = out[("ideal", "adaptive")]["tile"], out[("ideal",
                                                        "adaptive")]["stats"]
    cpu_tile, cpu_st = encode_class_tile(w.cpu(), None, variability=False,
                                         adaptive=True)
    err = allclose("tune_adaptive on the card vs the CPU (ideal devices)",
                   tile.g.cpu(), cpu_tile.g, 1e-6)
    for k in ("pretune_prog", "pretune_erase"):
        exact(f"tune_adaptive {k} on the card vs the CPU", st[k].cpu(),
              cpu_st[k])
    print(f"tune_adaptive on ideal devices: the card's conductances match "
          f"the CPU run (max abs err {err:.3e} S), pulse counts equal")
    return out


def static_path(served: dict, trained: dict, compressed: dict,
                device, card: str) -> dict:
    """Phase 9: the cost model, the static audit and the adaptive
    programmer on the card."""
    t0 = time.perf_counter()
    cost = cost_model_phase(served["system"], card)
    sessions = [s for sys_ in (served["system"], compressed["system"])
                for s in sys_._sessions.values() if s.compiled_shapes()]
    sessions.append(trained["online_session"])
    audit = audit_phase(sessions, card)
    adaptive = adaptive_phase(trained, device, card)
    print(f"phase cost model, audit and adaptive tuning: done in "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(cost=cost, audit=audit, adaptive=adaptive)


def kernel_resources(source: str) -> list[str]:
    """Each kernel of ``source`` with its registers, shared memory and
    spills, from the build's ``nvcc --resource-usage`` report."""
    from repro_torch.kernels import _build
    return [f"{name}: {r.registers} registers, {r.smem} B smem, stack "
            f"{r.stack} B, spill stores {r.spill_stores} B, spill loads "
            f"{r.spill_loads} B"
            for name, r in _build.resource_table(source).items()]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a "
              "CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch
    from repro_torch import kernels

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, package {repro_torch.__name__}; "
          f"host: {os.cpu_count()} CPUs, load average "
          + " / ".join(f"{x:.2f}" for x in os.getloadavg()))
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("TF32 is on: the port's f32 contract needs it off")
    print(f"phase build: nvcc for sm_90a, {kernels.build_all():.1f} s")
    for source in ("crossbar_mvm.cu", "fused_impact.cu", "ta_feedback.cu",
                   "digital_cotm.cu"):
        for line in kernel_resources(source):
            print(f"  {source} {line}")

    t0 = time.perf_counter()
    errs = check_kernels(device)
    errs.update(check_packed_kernels(device))
    for k, v in check_tail_lanes(device).items():
        errs[k] = max(errs[k], v)
    errs.update(check_training_kernels(device))
    errs["class_sum"] = max(errs["class_sum"], check_class_sum(device))
    print(f"phase kernels: all kernels match their plain versions "
          f"({time.perf_counter() - t0:.1f} s); max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    t0 = time.perf_counter()
    served = serve_path(device)
    print(f"phase serving path: done in {time.perf_counter() - t0:.1f} s; "
          f"launches {served['launches']}")

    t0 = time.perf_counter()
    trained = train_path(device)
    print(f"phase training path: done in {time.perf_counter() - t0:.1f} s; "
          f"launches {trained['launches']}")

    t0 = time.perf_counter()
    compressed = compressed_path(device, trained)
    print(f"phase compressed path: done in {time.perf_counter() - t0:.1f} s; "
          f"launches {compressed['launches']}")

    profile_engines(served, np.tile(digit_literals(1024, seed=SEED + 7),
                                    (8, 1)))
    profile_packed(compressed)
    profile_training(trained)
    rows = (time_kernels(served, errs) + time_packed_kernels(compressed, errs)
            + time_training_kernels(trained, errs))
    for r in rows:
        print(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
              f"ms by {r['bound_by']}), {r['launches']} launches on the path")

    t0 = time.perf_counter()
    coresident = coresident_path(device)
    print(f"phase co-resident path: done in {time.perf_counter() - t0:.1f} "
          f"s; crossbar_mvm launches "
          f"{coresident['launches']['crossbar_mvm_f32']}")

    static_path(served, trained, compressed, device, card)
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

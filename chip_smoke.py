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
   shapes;
4. the serving path at paper width (K=1568 literals, n=500 clauses, m=10
   classes, capacity 128): ``build_system`` with device variability,
   sessions for every metering mode, ``predict`` / ``infer_with_report``,
   ``IMPACTEngine`` serving and a Poisson ``replay_trace``, with the
   launch counters showing every kernel ran on that path;
5. times: the device's busy share while the engine serves (under
   ``torch.profiler``), then each kernel, its plain version and one
   PyTorch call for the same function, in CUDA-event medians.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
reference package.
"""
from __future__ import annotations

import gc
import json
import os
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

# Published peaks of one H100 SXM (NVIDIA data sheet, 700 W): f32 outside
# the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


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
    from repro_torch.kernels.fused_impact import (fused_impact,
                                                  fused_impact_metered)
    cuda_bk = backends.get_backend("cuda")
    torch_bk = backends.get_backend("torch")
    errs = dict(fused_impact=0.0, fused_impact_metered=0.0, crossbar_mvm=0.0)
    for i, shape in enumerate(KERNEL_SHAPES):
        s = synthetic_system(shape, device, seed=i)
        args = (s["literals"], s["clause_i"], s["nonempty"], s["class_i"])
        got = fused_impact(*args, thresh=TH)
        want = ref.fused_impact_ref(*args, thresh=TH)
        exact(f"fused_impact argmax {shape}", got.argmax(-1), want.argmax(-1))
        errs["fused_impact"] = max(errs["fused_impact"], allclose(
            f"fused_impact scores {shape}", got, want, RTOL_SCORES))

        g_sc, g_cl, g_cs = fused_impact_metered(*args, thresh=TH)
        w_sc, w_cl, w_cs = ref.fused_impact_metered_ref(*args, thresh=TH)
        exact(f"fused_impact_metered argmax {shape}", g_sc.argmax(-1),
              w_sc.argmax(-1))
        errs["fused_impact_metered"] = max(
            errs["fused_impact_metered"],
            allclose(f"fused_impact_metered scores {shape}", g_sc, w_sc,
                     RTOL_SCORES),
            allclose(f"fused_impact_metered clause meter {shape}", g_cl, w_cl,
                     RTOL_CLAUSE_METER),
            allclose(f"fused_impact_metered class meter {shape}", g_cs, w_cs,
                     RTOL_CLASS_METER))

        # crossbar_mvm through the staged compositions (CSA bits exact) ...
        f_k, i_k = cuda_bk.impact_clause_bits(*args[:3], thresh=TH)
        f_p, i_p = torch_bk.impact_clause_bits(*args[:3], thresh=TH)
        exact(f"staged clause bits {shape}", f_k, f_p)
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
    torch.cuda.synchronize()
    return errs


# -- phase 4 --------------------------------------------------------------

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
    for sym, n in out["launches"].items():
        if n == 0:
            fail(f"{sym} was never launched on the serving path")

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


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_b = bytes_moved / PEAK_HBM_BYTES * 1e3
    t_o = flops / PEAK_F32_FLOPS * 1e3
    return (t_o, "operations") if t_o >= t_b else (t_b, "bytes")


def time_kernels(served: dict, errs: dict) -> list[dict]:
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels import ref
    from repro_torch.kernels.crossbar_mvm import crossbar_mvm
    from repro_torch.kernels.fused_impact import (fused_impact,
                                                  fused_impact_metered)
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
    # (rows past K have no drive), and the class rows of the C*tc clause
    # columns (the rest have no drive either).
    live = min(C * tc, S * sr)
    drive = 1.0 - lits.float()                             # (B, K)
    ccur = ci[0, :, :Kl].transpose(0, 1).reshape(Kl, C * tc).contiguous()
    wcur = cls.reshape(S * sr, M)[:live].contiguous()

    # Library yardstick for #1/#2: the two-matmul composition.
    def two_matmuls():
        fired = (torch.matmul(drive, ccur) < TH) & ne
        return torch.matmul(fired[:, :live].float(), wcur)

    in_bytes = (lits.numel() + ccur.numel() * 4 + ne.numel()
                + wcur.numel() * 4)
    fl_fused = 2.0 * B * Kl * C * tc + 2.0 * B * live * M
    print(f"fused_impact work: {fl_fused:.0f} flop on {in_bytes} B in")
    rows = []
    for name, fn, plain, extra_out in (
            ("fused_impact", lambda: fused_impact(*args, thresh=TH),
             lambda: ref.fused_impact_ref(*args, thresh=TH), 0),
            ("fused_impact_metered",
             lambda: fused_impact_metered(*args, thresh=TH),
             lambda: ref.fused_impact_metered_ref(*args, thresh=TH), 2 * B)):
        b_ms, b_by = bound_ms(in_bytes + (B * M + extra_out) * 4, fl_fused)
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
    d_cl, g_cl = calls[0]
    d_cs, g_cs = calls[1]
    by = sum(d.numel() * 4 + g.numel() * 4 + d.shape[0] * g.shape[1] * 4
             for d, g in calls)
    fl = sum(2.0 * d.shape[0] * d.shape[1] * g.shape[1] for d, g in calls)
    b_ms, b_by = bound_ms(by, fl)
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

    per_call = [cuda_ms(lambda d=d, g=g: crossbar_mvm(d, g, v_read=1.0,
                                                      cutoff=0.0))
                for d, g in calls]
    print(f"crossbar_mvm per call: clause stage {tuple(d_cl.shape)}x"
          f"{tuple(g_cl.shape)} {per_call[0]:.4f} ms, class stage "
          f"{tuple(d_cs.shape)}x{tuple(g_cs.shape)} {per_call[1]:.4f} ms")
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
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    return [{k: r[k] for k in order} for r in rows]


def profile_engines(served: dict, lits: np.ndarray) -> None:
    """One more burst per metering mode under ``torch.profiler``; prints
    the device's busy share of the burst's wall time and the kernels that
    took it."""
    from torch.profiler import ProfilerActivity, profile
    for m in ("off", "fused", "staged"):
        eng = served[f"engine_{m}"]["engine"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.run(lits)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kern[e.name] = kern.get(e.name, 0.0) + e.time_range.elapsed_us()
        busy = sum(kern.values()) * 1e-6
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
        print(f"profile metering={m}: wall {wall * 1e3:.3f} ms, device busy "
              f"{busy * 1e3:.3f} ms ({100 * busy / wall:.2f}% of wall); top: "
              + "; ".join(f"{n[:60]} {t / 1e3:.3f} ms" for n, t in top))


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

    t0 = time.perf_counter()
    errs = check_kernels(device)
    print(f"phase kernels: all kernels match their plain versions "
          f"({time.perf_counter() - t0:.1f} s); max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    t0 = time.perf_counter()
    served = serve_path(device)
    print(f"phase serving path: done in {time.perf_counter() - t0:.1f} s; "
          f"launches {served['launches']}")

    profile_engines(served, np.tile(digit_literals(1024, seed=SEED + 7),
                                    (8, 1)))
    rows = time_kernels(served, errs)
    for r in rows:
        print(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
              f"ms by {r['bound_by']}), {r['launches']} launches on the path")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

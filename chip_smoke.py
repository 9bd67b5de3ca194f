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
   four fused kernels also at 1000 and 300 lanes, where the tail gives a
   lane several warps or a block several lanes, and at the benchmark's
   16,384 lanes in its MNIST and CIFAR-2 layouts (the tail's device time
   a call there and at 128 lanes is printed last, ``time_tail``, after
   pass 1's on each fused benchmark cell's first pool batch,
   ``time_pass1``); the paired pass 1 at the benchmark's layouts, ragged
   lane counts and a plain-load shape on paired, unpaired and
   one-unpaired-lane literals, CSA bits exact, and the R = 2 head
   layout on the full pass (``check_paired``); the packed twins also on
   codes one and four bytes past an aligned base (plain loads, 4-byte
   copies);
   ``class_sum`` also on signed int8 clauses, past 16 classes, at one
   clause, on clauses one byte off and with no lane, class or clause,
   bit for bit equal from launch to launch;
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
   one equal to the CPU run;
10. graphs: every prepared entry of the sessions of phases 4, 6 and 8
   and the trainer's, each serving session's entries also at B = 1, 8
   and its capacity, is one captured CUDA graph: (a) a call equals the
   eager body (``entry_fn``) bit for bit on literals that fire clauses;
   (b) a result is unchanged by the next call; (c) after one online
   update every session of the trainer's system (both packings, three
   meterings) serves the new operands; (d) no entry is prepared again
   over the phase, nor over phase 4's bursts; (e) a graphed call counts
   the launches an eager one does; (f) a graphed call on device-resident
   operands syncs nothing under ``set_sync_debug_mode("error")``; (g)
   ``audit()`` is ok with its graph check, and each graph's nodes are
   printed; (h) host walls of phase 9 (a)'s families graphed against the
   eager body at B = 8, 32 and 128, the host time of one replay and one
   copy in, and the engine's requests/s graphed against the eager body
   under each metering;
11. the sharded crossbar (Fig. 14 over ``torch.distributed``): one spawn
   of four processes on the card forms a gloo world of 4 (data 2 x model
   2), then its first two ranks regroup as a world of 2 (model 2).  In
   each world every rank builds the paper-width model on ideal devices at
   three placements, (R, C, S) = (4, 4, 4), (4, 4, 1) and (13, 8, 8)
   (plans both, R-only and S-only), and holds, against the single-device
   session on the card: CSA bits through the sharded lowering exact (f32
   and 2-bit), every packing x metering's predictions (ties as in phase
   8), scores, free lanes, lane meters and report, a sharded engine's
   bills against its batch meter, its ``crossbar_mvm`` calls (launch
   counters, in windows around the sharded calls only) and its device
   kernels (``torch.profiler``) against ``cost_analysis``, ``audit()``
   and the entries' preparations; then the host walls of ``predict`` and
   ``infer_step`` at B = 8, 32 and 128, sharded against one device.  Any
   rank's failure fails the phase;
12. the LM slice (``repro_torch.models``): (a) llama3-8b at full width and
   depth (32 layers, d 4096, 8.0e9 f32 parameters drawn on the card from a
   seeded generator, bf16 compute) prefills 4 prompts of 512 tokens into
   a cache of 1024, then decodes 16 greedy steps; every decode step's
   logits against ``forward`` on the prompt extended by the fed tokens,
   every cache length exact, peak memory printed; (b) its first 2 layers
   with embedding and head in f32, on the card against the CPU; (c) the
   CoTM head (``TMHead``, 8192 literals, 500 clauses, 10 classes) on the
   pooled prompt states through ``fused_cotm``, bit for bit against
   ``fused_cotm_ref`` on the card, then 60 training steps on two classes
   of sequences over frozen embeddings, accuracy above chance; the launch
   counters of (a) and (c)'s main path show ``fused_cotm``; (d) the other
   seven transformer-family configs at full width, one layer deep
   (deepseek: its dense front layer and one MoE layer), prefill and two
   greedy decode steps each against ``forward``; (e) prefill tokens/s and
   decode-step ms of (a) (CUDA events), and ``fused_cotm`` at the head's
   shape: kernel, plain version, one PyTorch call and bound, a second row
   of the kernel table;
13. the ssm and hybrid families through the LM ``Engine``: (a) rwkv6-7b
   and (b) zamba2-7b at full width and depth (7.6e9 and 6.9e9 f32
   parameters drawn on the card, one model at a time, bf16 compute):
   ``generate`` 4 prompts of 512 tokens for 16 greedy tokens (max_len
   1024), then ``serve_continuous`` of 6 requests (max_new 4-12,
   capacity 4), each request's tokens equal to ``generate``'s on its
   prompt (a difference only at a tie its step's own logit gap
   explains); the same prefill and decode steps by hand between CUDA
   events give the engine's tokens, every recurrent state finite; each
   layer's (zamba2: each mamba layer's and each shared-block
   invocation's) decode step teacher-forced against the forward's, the
   first layers (rwkv6: 2; zamba2: 6 mamba layers and one shared block)
   through prefill and 16 ``decode_step``s held to ``forward``, the end
   to end gap printed; zamba2 also generates with max_len 256 (its ring
   wraps under the 512-token prompt), the ring's len and positions exact
   after the prefill and each step; (c) those first layers in f32 on the
   card against the CPU; (d) the CoTM head on the pooled prompt states
   through ``fused_cotm`` (K = 8192 and 7168) bit for bit against
   ``fused_cotm_ref``, each model's launch counters showing
   ``fused_cotm``; (e) prefill tokens/s, decode-step ms (CUDA events),
   ``serve_continuous`` requests/s and latency p50 / p99 (host clock),
   peak memory, and ``fused_cotm`` at (4, 7168, 500, 10), a third row of
   the kernel table;
14. LM training (``repro_torch.train``, ``repro_torch.train_lm``), which
   reaches no kernel of the port: (a) llama3-8b at full width, 8 layers
   deep (the 32-layer training state, 128.5 GB, does not fit the card),
   2.8e9 f32 master parameters drawn on the card, bf16 compute, remat,
   f32 moments, 6 AdamW steps of 2 microbatches of 4 x 512
   ``synth_tokens`` on the repeated batch through ``make_train_step``:
   loss and grad norm finite every step, the last loss below the first,
   every leaf updated; (b) its first layer in f32, one step at B = 2,
   S = 64 on the card against the CPU (loss, each leaf's gradient, the
   updated parameters); (c) every other config at full width one layer
   deep (deepseek: its dense front layer and one MoE layer; zamba2: 6
   mamba layers and the shared block; grok-1 as ``train_lm``'s ~100M
   variant), 2 steps and a gradient finite and nonzero at every leaf; (d)
   ``train_lm.train`` at the reference example's size (batch 8, seq 256),
   60 steps, then a run that fails at step 30 and one that resumes it:
   the resumed losses equal the uninterrupted run's bit for bit, the loss
   falls, the heartbeat is written; (e) ``int8_psum`` and
   ``compressed_grad_allreduce`` in a gloo world of 4 on the card, bit for
   bit against CPU tensors; (f) (a)'s step, forward + backward of each
   microbatch and optimizer times (CUDA events), tokens/s, model FLOPs as
   a share of the bf16 peak, peak memory against the state, and one
   step under ``torch.profiler`` (busy share, largest device items);
15. ZeRO training on a mesh (``repro_torch.train`` with
   ``grad_shardings`` / ``param_shardings`` / ``state_shardings``; for
   llama3-8b the step computes tensor parallel over the model axis),
   which reaches no kernel of the port: one spawn of four processes on
   the card forms a gloo world of 4 (data 2 x model 2; NCCL refuses two
   ranks on one card); the parent holds no CUDA memory beyond its
   context.  (a)
   llama3-8b at full width, 2 layers deep, its own posture (``zero3``
   off, f32 ``opt_rules`` moments, bf16 compute, remat), 3 AdamW steps
   of 2 microbatches of 4 x 512 ``synth_tokens``: every rank holds only
   its shard of each leaf, the loss falls, every replicated shard (the
   parameters over the data axis, the norms over the model axis) is the
   same bits on every rank after each step (a position-weighted sum of
   its bits), each rank's peak memory and the step time printed; (b)
   one f32 layer at full width with wq and wk scaled as in phase 14 (b),
   ``zero3`` on, one step at B = 2, S = 64: first on one device in a
   process of its own, then in the world on the same weights: the loss
   within rtol 1e-5, each leaf's gathered gradient and update within
   1e-2 in relative Frobenius norm; (c) the world's state after (b)
   saved (every rank gathers, rank 0 writes), restored on one device and
   on a 1 x 4 mesh of the same world, every leaf bit for bit the gathered
   state; (d) the phase's wall time;
16. tensor-parallel compute over the model axis (``repro_torch.models``
   built with a ``ShardCtx`` on a mesh; the three explicit legs of the
   reference): one process computes the one-device references, then one
   spawn of four forms a gloo world of 4 on the card with the 2 x 2 and
   1 x 4 meshes.  (a) llama3-8b and (b) deepseek-v2-lite-16b (its dense
   front layer and one MoE layer of 64 experts, 32 a rank through
   ``_routed_ep``) on 2 x 2, (c) qwen2-vl-2b with 16 patch embeddings
   and M-RoPE positions on 1 x 4 (its 2 KV heads take the head_dim
   decode leg), (f) rwkv6-7b on 2 x 2 and (g) zamba2-7b on 1 x 4 (7
   layers: a group of 6 mamba layers, the shared block, a tail layer;
   its ``in_proj`` blocks cut across z | x | B | C | dt), each at full
   width and 2 layers deep (zamba2 7): every rank holds
   its blocks of the one-device weights, a prefill of 4 x 512 and 16
   decode steps fed the one-device run's greedy tokens through
   ``prefill`` / ``decode_step``, the logits end to end at bounds set
   from TP's own readings on the card, each layer teacher-forced on the
   one-device run's input to it (prefill and every step) at phase 12's
   layer bounds (the tight gate), the TP greedy tokens printed; no
   collective over the model axis carries a tensor of the shape of a
   weight that the rules split over it; each
   rank's share of the parameters, peak memory, prefill and decode-step
   times (CUDA events and host wall) and the bytes it sends over each
   mesh axis a prefill and a decode step; (a) and (f) also 3 ZeRO + TP
   AdamW steps of phase 15 (a)'s batch, (g) one (falling loss,
   replicated shards the same bits, bytes a step, the step computing on
   its model-axis blocks), and (f) one f32 rwkv6 layer's loss and
   gradient against one device at phase 15 (b)'s bounds; (d)
   ``chunked_attention``'s context-parallel leg on 1 x 4 at (4, 256, 6,
   16) f32 and (2, 4096, 6, 128) bf16 within 2e-2 of one device; (e)
   the CoTM head on the pooled prefill states of (a), (f) and (g)
   (gathered whole), one ``fused_cotm`` launch each in rank 0's own
   count window, bit for bit against ``fused_cotm_ref``, added to the
   head's row of the kernel table at its K (8192 or 7168);
17. the dry run against the card (``repro_torch.launch.dryrun.measure``:
   the step on ``meta`` in a fake process group of the mesh's shape; it
   launches no kernel): started at the script's start in a process of
   its own that does not see the card, it runs the cells the card ran,
   at their configs, depths and batches: phase 14 (f)'s llama3-8b x 8
   step on one device, phase 16 (a)'s llama3-8b x 2 prefill of 4 x 512
   and ZeRO + TP step on 2 x 2, and (g)'s zamba2-7b x 7 prefill and
   step on 1 x 4.  Gates: each cell's per-rank state bytes (parameters
   and moments) equal what every real rank held, and its bytes by mesh
   axis equal, exactly, what the same run's ``record_traffic`` counted
   on every rank (nothing, on one device); printed beside them, not
   gated: the predicted peak (arguments + temp) against
   ``torch.cuda.max_memory_allocated`` over the same step, and the
   card's ``total_memory`` against ``dryrun.HBM_BYTES``;
18. the paper's experiments (``repro_torch.paper``) between one reset and
   one read of the launch counts: Tables 4 and 6 and Fig. 13 on phase
   5's trained parameters (the paper's MNIST CoTM config, passed in, not
   retrained), Table 5 on all seven datasets (2000 samples, 6 epochs;
   cifar2 and human_activity take two 512-column clause tiles), Figs. 7-8
   at c2c(60) / d2d(100); gates: Table 4's own (fused predictions equal
   the staged ones, clause and class energy and TOPS/W within rtol 1e-4),
   ``fused_impact``, ``fused_impact_metered`` and ``crossbar_mvm``
   launched in the phase (their launches added to rows 1-3 of the kernel
   table), then ``fused_impact`` on the trained cifar2 system's own
   operands against its plain version: CSA bits (through an identity
   class operand) and argmax exact, scores at rtol 1e-6; the phase's and
   each section's wall printed.
19. the MLA prefill flash kernel (``kernels.flash_attention``,
   ``csrc/flash_mla.cu``): (a) the main path, DeepSeek-V2-Lite whole at
   its published settings (27 layers, bf16) through ``model.hidden`` at
   the benchmark's ``dsv2lite.docs-bulk`` largest batch (8 x 4,096),
   between one reset and one read of the launch counts and the tracing
   table: ``flash_mla_prefill`` launched once a layer, ``attn.kernel_calls``
   one a layer, no ``attn.plain_calls``, the states finite; (b) the
   kernel at the cell's eight padded batch shapes (8 documents of
   512-4,096 positions, 16 heads, q and k as their parts with one shared
   rope key): against its plain version at f32 output, two launches
   bitwise equal; then per shape the kernel's CUDA-event median, its
   bound (the causal triangle's FLOPs at the bf16 peak or its bytes at
   the HBM rate, whichever is larger), the plain version's time and
   ``scaled_dot_product_attention`` on the whole operands as
   ``library_ms`` (a yardstick the port never calls); a row of the kernel
   table at the largest shape, with (a)'s launches.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
reference package.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import json
import math
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


NUMERICS_DRAWS = 1_000_000     # f32 draws for sqrt_rn / rsqrt_rn


def check_numerics(device) -> dict:
    """``numerics.sqrt_rn`` / ``rsqrt_rn`` on the card against their f64
    route (each f32 rounded once from the f64 result, on the host) on
    NUMERICS_DRAWS f32 draws spread log-uniformly over 2^-60 .. 2^60:
    exact.  Also counts how many of ``torch.sqrt`` / ``torch.rsqrt``'s own
    f32 results on the card differ from that route (not gated)."""
    from repro_torch.numerics import rsqrt_rn, sqrt_rn
    gen = torch.Generator().manual_seed(SEED)
    x = torch.exp2(torch.empty(NUMERICS_DRAWS, dtype=torch.float64)
                   .uniform_(-60.0, 60.0, generator=gen)).float()
    x64 = x.double()
    want = dict(sqrt=torch.sqrt(x64).float(),
                rsqrt=torch.sqrt(x64).reciprocal().float())
    xc = x.to(device)
    exact("sqrt_rn on the card", sqrt_rn(xc).cpu(), want["sqrt"])
    exact("rsqrt_rn on the card", rsqrt_rn(xc).cpu(), want["rsqrt"])
    return {f"torch.{k}": int((getattr(torch, k)(xc).cpu() != w).sum())
            for k, w in want.items()}


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


# The benchmark's bulk batch in its two layouts (perfbench/configs): MNIST
# on one 2048 x 512 clause tile, M = 10; CIFAR-2 on 1 x 2 tiles, M = 2.
BULK_BATCH = 16_384
BULK_SHAPES = [(BULK_BATCH, K, N_CLAUSES, M_CLASSES, 1, 2048, 1, 512, 1, 2048),
               (BULK_BATCH, 2048, 1000, 2, 1, 2048, 2, 512, 1, 2048)]
TAIL_TIMED_CALLS = 20


def check_tail_lanes(device) -> dict[str, float]:
    """The four fused kernels at the batches whose tails take other
    decompositions: the paper layout at the compressed path's
    calibration batch (N_CALIBRATION lanes) and at 300 lanes, the ragged
    multi-shard layout at both, and the benchmark's two layouts at
    BULK_BATCH lanes, against their plain versions as ``check_fused``
    holds them.  On the card the plans must give a lane several warps, a
    block several lanes, and the bulk batch full blocks.  Returns the max
    absolute error per kernel."""
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels import packing
    from repro_torch.kernels.crossbar_mvm import sm_count
    from repro_torch.kernels.fused_impact import TAIL_THREADS, plan
    errs = dict(fused_impact=0.0, fused_impact_metered=0.0,
                fused_impact_packed=0.0, fused_impact_packed_metered=0.0)
    plans = []
    shapes = [(B,) + KERNEL_SHAPES[base][1:]
              for B, base in ((N_CALIBRATION, 0), (300, 0),
                              (N_CALIBRATION, 2), (300, 2))] + BULK_SHAPES
    for i, shape in enumerate(shapes):
        B, K_, _, _, R, tr, C, tc, _, _ = shape
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
                plans.append((B, p))
                print(f"{names[0]} tail {shape}: {p.tail_blocks} blocks of "
                      f"{p.lanes} lane(s), {p.tail_warps} warp(s) a lane; "
                      f"max abs err {e:.3e} / {e_m:.3e} (metered)")
    if device.type == "cuda":
        if not (any(p.tail_warps > 1 for _, p in plans)
                and any(p.lanes > 1 for _, p in plans)):
            fail("tail plans: no lane took several warps, or no block "
                 "several lanes")
        if any(p.tail_threads != TAIL_THREADS for B, p in plans
               if B == BULK_BATCH):
            fail(f"tail plans: a block at {BULK_BATCH} lanes is not full")
    torch.cuda.synchronize()
    return errs


def time_tail(device, calls: int = TAIL_TIMED_CALLS) -> None:
    """The four fused kernels at the serving capacity (paper layout) and
    at BULK_SHAPES, ``calls`` calls each in one ``torch.profiler`` window
    a shape: ``impact_tail``'s device time a call, printed beside pass
    1's (the f32 and packed entries share a tail variant).  Run last:
    after these windows of long kernels, later profiled windows were
    seen to lose their first kernels' events (``profile_training``'s
    count of ``ta_feedback`` kernels)."""
    from repro_torch.analysis.profile_window import device_profile
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels import packing
    from repro_torch.kernels.fused_impact import (
        fused_impact, fused_impact_metered, fused_impact_packed,
        fused_impact_packed_metered)
    for i, shape in enumerate([KERNEL_SHAPES[0]] + BULK_SHAPES):
        s = synthetic_system(shape, device, seed=70 + i)
        pk = packing.pack_clause_operand(s["clause_i"])
        f32 = (s["literals"], s["clause_i"], s["nonempty"], s["class_i"])
        codes = (s["literals"], pk.bits, pk.levels, s["nonempty"],
                 s["class_i"])
        tr = shape[5]
        runs = ((fused_impact, f32, {}), (fused_impact_metered, f32, {}),
                (fused_impact_packed, codes, dict(tr=tr)),
                (fused_impact_packed_metered, codes, dict(tr=tr)))
        for fn, args, kw in runs:
            fn(*args, thresh=TH, **kw)
        torch.cuda.synchronize()
        with device_profile() as prof:
            for fn, args, kw in runs:
                for _ in range(calls):
                    fn(*args, thresh=TH, **kw)
            torch.cuda.synchronize()
        print_fused_passes(f"B={shape[0]} K={shape[1]} "
                           f"C*tc={shape[6] * shape[7]}", *pass_times(prof))


# The paired pass 1 (``fused_impact.pairs``: f32 cells, K even, K <= tr):
# the benchmark's MNIST and CIFAR-2 layouts at the serving capacity,
# ragged lane counts in the MNIST layout, K/2 = 150 (plain literal loads)
# with tc = 30 (4-byte cell copies); then the DeepSeek-V2-Lite head's two
# row shards (K = 4096 > tr), which run the full pass.
PAIRED_SHAPES = [(CAPACITY,) + BULK_SHAPES[0][1:],
                 (CAPACITY,) + BULK_SHAPES[1][1:],
                 (1,) + BULK_SHAPES[0][1:], (65,) + BULK_SHAPES[0][1:],
                 (BULK_BATCH + 1,) + BULK_SHAPES[0][1:],
                 (37, 300, 77, 3, 1, 300, 3, 30, 5, 16),
                 (CAPACITY, 4096, 500, 10, 2, 2048, 1, 512, 1, 2048)]


def paired_literals(B: int, K_: int, rng, device,
                    unpaired_lanes=()) -> torch.Tensor:
    """Literals (B, K) in the system's ``[bits, ~bits]`` layout, except
    ``unpaired_lanes``, which hold independent fair {0, 1} draws."""
    bits = rng.random((B, K_ // 2)) < 0.5
    lit = np.concatenate([bits, ~bits], axis=1)
    for b in unpaired_lanes:
        lit[b] = rng.random(K_) < 0.5
    return torch.as_tensor(lit, device=device).to(torch.int8)


def check_paired(device) -> dict[str, float]:
    """``fused_impact`` and ``fused_impact_metered`` at ``PAIRED_SHAPES``
    on paired literals, on fair {0, 1} draws (no pair holds by design:
    every stage runs the second loop) and on paired literals with one
    unpaired lane, against their plain versions as ``check_fused`` holds
    them (argmax exact, run to run bit for bit); the CSA bits exact
    through an identity class operand.  On the card each shape must take
    the pass it is meant to, by ``describe`` and by the program counters
    ``impact.paired_launches`` / ``impact.full_launches``.  Returns the
    max absolute error per kernel."""
    from repro_torch import tracing
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels import backends
    from repro_torch.kernels.fused_impact import (FULL_LAUNCHES,
                                                  PAIRED_LAUNCHES, describe,
                                                  fused_impact, pairs)
    torch_bk = backends.get_backend("torch")
    errs = dict(fused_impact=0.0, fused_impact_metered=0.0)
    rng = np.random.default_rng(90)
    for i, shape in enumerate(PAIRED_SHAPES):
        B, K_, n, _, R, tr, _, _, S, sr = shape
        s = synthetic_system(shape, device, seed=90 + i)
        kinds = {"paired": paired_literals(B, K_, rng, device),
                 "unpaired": s["literals"]}
        if B > 1:
            kinds["one unpaired lane"] = paired_literals(
                B, K_, rng, device, unpaired_lanes=(B // 2,))
        want_paired = pairs(K_, tr)
        for kind, lit in kinds.items():
            args = (lit, s["clause_i"], s["nonempty"], s["class_i"])
            label = f"{shape} {kind}"
            tracing.reset()
            tracing.enable()
            try:
                e, e_m = check_fused(label, args, TH)
            finally:
                tracing.disable()
            counts = {k: v["count"] for k, v in tracing.totals().items()}
            tracing.reset()
            errs["fused_impact"] = max(errs["fused_impact"], e)
            errs["fused_impact_metered"] = max(errs["fused_impact_metered"],
                                               e_m)
            # Scores through an identity class operand are the CSA bits.
            got = fused_impact(lit, s["clause_i"], s["nonempty"],
                               identity_class(S, sr, n, device), thresh=TH)
            f_p, i_p = torch_bk.impact_clause_bits(lit, s["clause_i"],
                                                   s["nonempty"], thresh=TH)
            csa_bits_exact(f"paired pass CSA bits {label}", got > 0.5,
                           f_p[:, :n], i_p, TH)
            if lit.is_cuda:
                path = describe(lit, s["clause_i"])
                if ("paired pass" in path) != want_paired:
                    fail(f"paired pass {label}: {path}")
                # check_fused launches each of its two kernels twice.
                want = {PAIRED_LAUNCHES: 4 * want_paired,
                        FULL_LAUNCHES: 4 * (not want_paired)}
                got_counts = {k: counts.get(k, 0) for k in want}
                if got_counts != want:
                    fail(f"paired pass {label}: pass-1 counters "
                         f"{got_counts}, want {want}")
                print(f"fused_impact {label}: {path}; max abs err "
                      f"{e:.3e} / {e_m:.3e} (metered)")
    torch.cuda.synchronize()
    return errs


# The benchmark's fused cells (perfbench/configs, perfbench/traffic): the
# first batch of the pool each draws from this seed.
PASS1_CELLS = ("cotm-mnist", "cotm-cifar2")
PASS1_TRAFFIC = "bulk-fused"
PASS1_SEED = 2718281828
PASS1_TIMED_CALLS = 20


def time_pass1(device, calls: int = PASS1_TIMED_CALLS,
               seed: int = PASS1_SEED) -> None:
    """``fused_impact_metered`` on the first pool batch (16,384 lanes) of
    each benchmark cell of ``PASS1_CELLS``, deployed and drawn as the
    cell does from ``seed`` (``perfbench.families.cotm``), ``calls``
    calls in one ``torch.profiler`` window a cell: pass 1's and the
    tail's device time a call, printed.  It calls only the wrapper, so
    it times an older checkout's kernels as well, with that checkout's
    ``src`` first on the path."""
    from perfbench.families import cotm
    from repro_torch.analysis.profile_window import device_profile
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.impact.yflash import read_current
    from repro_torch.kernels.fused_impact import fused_impact_metered
    with open(os.path.join(ROOT, "perfbench", "traffic",
                           f"{PASS1_TRAFFIC}.json")) as f:
        traffic = dict(json.load(f), pool_batches=1)
    for name in PASS1_CELLS:
        with open(os.path.join(ROOT, "perfbench", "configs",
                               f"{name}.json")) as f:
            cfg = json.load(f)
        gen = torch.Generator(device=device).manual_seed(seed)
        dep = cotm.deploy(cfg, gen)
        lit = cotm.pool(dep, traffic, gen)[0]
        args = (lit, read_current(dep.clause_g).contiguous(), dep.nonempty,
                read_current(dep.class_g).contiguous())
        fused_impact_metered(*args, thresh=TH)
        torch.cuda.synchronize()
        # After the long profiled windows of earlier phases a window was
        # seen to record none of its kernels: profile again, up to twice.
        for attempt in range(3):
            with device_profile() as prof:
                for _ in range(calls):
                    fused_impact_metered(*args, thresh=TH)
                torch.cuda.synchronize()
            kern, n_calls = pass_times(prof)
            if calls in (n for k, n in n_calls.items() if "_tiles" in k):
                break
            print(f"  {name}: the profiled window holds "
                  f"{sum(n_calls.values())} kernels, not {calls} of pass "
                  f"1 (window {attempt + 1} of 3)")
        print_fused_passes(f"{name} first pool batch B={lit.shape[0]}",
                           kern, n_calls)


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
    out["burst_traces"] = {}
    for m, sess in sessions.items():
        eng = IMPACTEngine(sess, clock=time.perf_counter)
        eng.run(lits[:2 * CAPACITY])
        traces = sess.trace_count
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
        out["burst_traces"][m] = (traces, sess.trace_count)
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
    out["trainer"] = trainer
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
    from repro_torch.analysis.profile_window import device_profile
    for m in ("off", "fused", "staged"):
        eng = served[f"engine_{m}"]["engine"]
        with device_profile(cpu=True) as prof:
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
    from repro_torch.analysis.profile_window import device_profile
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
            with device_profile() as prof:
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
    from repro_torch.analysis.profile_window import device_profile
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
        with device_profile() as prof:
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
                tally: dict[str, int]):
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
    return zoo


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
    standby = zoo_standby(device, systems, includes, zoo["oracle"],
                          tallies["c"])
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
    # Every session of the path, for phase 10: the co-resident ones, the
    # zoos' (standby pools included) and the members' standalone ones.
    sessions = {id(s): s for sys_ in (full["combined"], *full["members"],
                                      *systems)
                for s in sys_._sessions.values()}
    for z in (zoo["zoo"], standby):
        for s in (z.session, *z._standby_sessions.values()):
            sessions[id(s)] = s
    return dict(launches=launches, class_calls=rows, zoo=zoo,
                sessions=list(sessions.values()))


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


# -- phase 10 -------------------------------------------------------------

# (a) Every serving session's entries also at these batches (a session's
# capacity stands in for CAPACITY where it has one).
GRAPH_BATCHES = (1, 8, CAPACITY)
# A clause cell that reads above this current is an include (HCS, ~uA;
# LCS reads ~nA): ``firing_rows`` sets its literal so the clause fires.
INCLUDE_A = 1e-7
# (h) Timed calls a median, two medians a (family, batch, way); engine
# windows of this many requests, three a way and metering mode.
GRAPH_SWEEPS, GRAPH_ENGINE_REQUESTS = 100, 16384


def includes(system) -> np.ndarray:
    """The (K, n) include mask a programmed system's clause cells hold."""
    R, C, tr, tc = system.clause_i.shape
    ci = system.clause_i.permute(0, 2, 1, 3).reshape(R * tr, C * tc)
    return (ci[:system.n_literals, :system.n_clauses]
            > INCLUDE_A).cpu().numpy()


def graph_operands(sess, entry: str, B: int, rng, inc=None) -> list:
    """Numpy operands of one ``(entry, B)`` call: literal rows that fire
    clauses of each lane's model (``firing_rows``), every 16th lane
    invalid, co-resident lanes round robin over the tenants; random TA
    feedback operands for ``ta_feedback``."""
    sys_ = sess.system
    K_, n = sys_.n_literals, sys_.n_clauses
    if entry == "ta_feedback":
        bits = lambda *shape, p=0.5: rng.random(shape) < p
        draws = lambda: rng.integers(0, 2 ** 31 - 1, (K_, n), dtype=np.int32)
        return [bits(B, K_).astype(np.int8), bits(B, n, p=0.3),
                bits(B, n), bits(B, n), draws(), draws(),
                bits(K_, n, p=0.05)]
    inc = includes(sys_) if inc is None else inc
    plan = sess.coresident
    if plan is None:
        args = [firing_rows(rng, inc, B)]
    else:
        mids = (np.arange(B) % plan.n_tenants).astype(np.int32)
        lits = np.ones((B, K_), np.int8)
        for b, t in enumerate(mids):
            sp = plan.spans[t]
            lits[b, sp.lit_lo:sp.lit_hi] = firing_rows(
                rng, inc[sp.lit_lo:sp.lit_hi, sp.col_lo:sp.col_hi], 1)[0]
        args = [lits]
    if entry != "predict":
        args.append(np.arange(B) % 16 != 15)
    if plan is not None:
        args.append(mids)
    return args


def on_device(sess, entry: str, args: list) -> list[torch.Tensor]:
    """The operands on the session's card in the entry's dtypes."""
    specs = sess.input_specs(entry, args[0].shape[0])
    return [torch.as_tensor(x, device=sess.device).to(d)
            for x, (_, d) in zip(args, specs)]


def reported(preds, i_cl_sum, i_cs_sum) -> tuple:
    """``infer_with_report``'s outputs as its report carries them."""
    from repro_torch.impact.yflash import T_READ, V_READ
    return (preds, float(V_READ * i_cl_sum * T_READ),
            float(V_READ * i_cs_sum * T_READ))


def graphed_call(sess, entry: str, args: list) -> tuple:
    """One call through the session's entry point, as a tuple."""
    if entry == "ta_feedback":
        return (sess.ta_feedback(*args),)
    mids = {"model_ids": args[-1]} if sess.coresident is not None else {}
    if sess.coresident is not None:
        args = args[:-1]
    if entry == "predict":
        r = sess.predict(*args, **mids)
        return r.predictions, r.scores
    if entry == "infer_step":
        r = sess.infer_step(*args, **mids)
        return r.predictions, r.e_clause_lanes, r.e_class_lanes
    r = sess.infer_with_report(*args, **mids)
    return (r.predictions, r.report.clause_energy_j,
            r.report.class_energy_j)


def eager_call(sess, entry: str, args: list) -> tuple:
    """The entry's eager body (``entry_fn``) on the same operands, moved
    to the card per call as a session did before its graphs."""
    out = sess.entry_fn(entry)(*on_device(sess, entry, args))
    out = out if isinstance(out, tuple) else (out,)
    return reported(*out) if entry == "infer_with_report" else out


def same(name: str, got: tuple, want: tuple) -> None:
    """Bit for bit: tensors ``torch.equal``, report sums ``==``."""
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, torch.Tensor):
            exact(f"{name} output {i}", g, w)
        elif g != w:
            fail(f"{name} output {i}: {g!r} != {w!r}")


class EagerSession:
    """A session whose ``infer_step`` runs the eager body: the host path
    before graphs, for phase 10 (h)'s engine windows."""

    def __init__(self, session):
        self._session = session

    def __getattr__(self, name):
        return getattr(self._session, name)

    def infer_step(self, literals, valid, model_ids=None):
        from repro_torch.impact.runtime import InferenceResult
        preds, e_cl, e_cs = eager_call(self._session, "infer_step",
                                       [literals, valid])
        return InferenceResult(predictions=preds, e_clause_lanes=e_cl,
                               e_class_lanes=e_cs)


def graph_entries(sessions) -> list[tuple]:
    """(session, entry, batch) of every prepared entry with a lane, and
    of each serving session's entries at ``GRAPH_BATCHES``."""
    keys = []
    for sess in sessions:
        if not sess.graphed:
            continue
        shapes = set(sess.compiled_shapes())
        if sess.capacity is not None:
            for e in {e for e, _ in shapes if e != "ta_feedback"}:
                shapes |= {(e, min(b, sess.capacity)) for b in GRAPH_BATCHES}
        keys += [(sess, e, b) for e, b in sorted(shapes) if b > 0]
    return keys


def check_graphs(keys, rng) -> dict:
    """(a), (b), (e), (f) on every (session, entry, batch) of ``keys``:
    the graphed call bit for bit equal to the eager body on literals
    that fire clauses, a result unchanged by the next call, the same
    launches counted a call either way, and no host sync in a graphed
    call on device-resident operands."""
    from repro_torch import kernels
    fired: dict[int, list[float]] = {}
    moved = 0
    incs: dict[int, np.ndarray] = {}
    for sess, e, b in keys:
        inc = incs.setdefault(id(sess.system), includes(sess.system))
        args = graph_operands(sess, e, b, rng, inc)
        other = graph_operands(sess, e, b, rng, inc)
        name = f"{sess!r} {e}@{b}"
        got = graphed_call(sess, e, args)
        same(f"(a) {name} graphed vs eager", got, eager_call(sess, e, args))
        if e == "predict":
            fired.setdefault(b, []).append(
                float((got[1] != 0).any(1).float().mean()))
        held = tuple(x.clone() if isinstance(x, torch.Tensor) else x
                     for x in got)
        graphed_call(sess, e, other)
        same(f"(b) {name} result after the next call", got, held)
        c0 = kernels.launch_counts()
        graphed_call(sess, e, args)
        c1 = kernels.launch_counts()
        eager_call(sess, e, args)
        c2 = kernels.launch_counts()
        d_graph = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
        d_eager = {k: c2[k] - c1[k] for k in c2 if c2[k] != c1[k]}
        if d_graph != d_eager:
            fail(f"(e) {name}: a graphed call counts {d_graph}, an eager "
                 f"one {d_eager}")
        moved += sum(d_graph.values())
        graph = sess.graph(e, b)
        dev = on_device(sess, e, args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph(*dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # A lone lane may draw only clauses that pruning retired.
    wide = [f for b, v in fired.items() if b >= 8 for f in v]
    if not wide or min(wide) <= 0.0:
        fail(f"(a) predict lanes with a nonzero score, by batch: {fired}")
    shares = [f for v in fired.values() for f in v]
    return dict(fired=(min(wide), statistics.median(shares)),
                launches=moved)


def refresh_check(trained: dict, rng) -> None:
    """(c) One online update of phase 5's trainer refreshes every session
    of its system in place; each graph then serves the new operands: its
    replay equals the eager body, which reads them, bit for bit."""
    from repro_torch.impact import RuntimeSpec
    trainer = trained["trainer"]
    system = trainer.system
    dev = str(system.device)
    for metering, pk in (("off", "none"), ("staged", "none"),
                         ("fused", "2bit"), ("staged", "2bit")):
        system.compile(RuntimeSpec(backend="cuda", metering=metering,
                                   packing=pk, capacity=CAPACITY, device=dev))
    sessions = list(system._sessions.values())
    keys = graph_entries(sessions)
    inc = includes(system)
    operands = {k: graph_operands(k[0], k[1], k[2], rng, inc) for k in keys}
    before = {k: graphed_call(k[0], k[1], a) for k, a in operands.items()}
    cells = system.clause_i.clone()
    _, lit_ho, y_ho = trained["data"]
    trainer.update(lit_ho[:ONLINE_BATCH], y_ho[:ONLINE_BATCH])
    if torch.equal(cells, system.clause_i):
        fail("(c) the online update wrote no cell")
    changed = 0
    for (sess, e, b), args in operands.items():
        got = graphed_call(sess, e, args)
        same(f"(c) {sess!r} {e}@{b} after refresh_operands", got,
             eager_call(sess, e, args))
        changed += any(not torch.equal(g, w) if isinstance(w, torch.Tensor)
                       else g != w for g, w in zip(got, before[sess, e, b]))
    if not changed:
        fail("(c) no refreshed graph's result moved with the update")
    print(f"phase 10 (c): one online update ({trainer.records[-1]['n_flips']}"
          f" flips) refreshed {len(sessions)} sessions in place; "
          f"{len(keys)} graphed entries equal the eager body on the new "
          f"operands, {changed} of them moved")


def graph_walls(system, card: str) -> dict:
    """(h) Host walls of phase 9 (a)'s families, graphed against the eager
    body, at COST_BATCHES (``host_sweep_s``, numpy literals in; the mean
    of two medians each way); the host time of one replay and of one
    operand's copy in."""
    from repro_torch.impact import RuntimeSpec
    dev = str(system.device)
    lits = digit_literals(max(COST_BATCHES), seed=SEED + 11)
    valid = np.ones(max(COST_BATCHES), bool)
    families = {f"predict/{b}": (RuntimeSpec(backend=b, metering="off",
                                             device=dev), "predict")
                for b in ("torch", "cuda")}
    families.update({f"infer_step/cuda-{m}": (RuntimeSpec(
        backend="cuda", metering=m, device=dev), "infer_step")
        for m in ("off", "fused", "staged")})
    families["infer_step/cuda-fused-2bit"] = (RuntimeSpec(
        backend="cuda", metering="fused", packing="2bit", device=dev),
        "infer_step")
    walls = {}
    for family, (spec, entry) in families.items():
        sess = system.compile(spec)
        for B in COST_BATCHES:
            args = [lits[:B]] + ([valid[:B]] if entry != "predict" else [])
            ways = {"graphed": lambda: graphed_call(sess, entry, args),
                    "eager": lambda: eager_call(sess, entry, args)}
            got = {w: [] for w in ways}
            for way in ("graphed", "eager", "eager", "graphed"):
                got[way].append(host_sweep_s(ways[way], GRAPH_SWEEPS))
            g, e = (statistics.mean(got[w]) for w in ways)
            walls[family, B] = (g, e)
            print(f"phase 10 (h) {family} B={B}: host wall graphed "
                  f"{g * 1e3:.4f} ms ("
                  + " / ".join(f"{t * 1e3:.4f}" for t in got["graphed"])
                  + f"), eager body {e * 1e3:.4f} ms ("
                  + " / ".join(f"{t * 1e3:.4f}" for t in got["eager"])
                  + f"), {e / g:.2f}x; medians of {GRAPH_SWEEPS}, in the "
                  f"order graphed, eager, eager, graphed; {card}")
    graph = system.compile(families["predict/cuda"][0]).graph(
        "predict", COST_BATCHES[0])
    x = lits[:COST_BATCHES[0]]
    for label, fn in (("replay", graph.replay),
                      ("copy in", lambda: graph.copy_in(x))):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t = []
        for _ in range(GRAPH_SWEEPS):
            t0 = time.perf_counter()
            fn()
            t.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        walls[label] = statistics.median(t)
        print(f"phase 10 (h) one {label} of predict@{COST_BATCHES[0]}, host "
              f"time without a synchronize: {walls[label] * 1e6:.2f} us "
              f"(median of {GRAPH_SWEEPS}); {card}")
    return walls


def engine_rates(served: dict, card: str) -> dict:
    """(h) Phase 4's engine on each metering's session, graphed against
    the eager body, windows of GRAPH_ENGINE_REQUESTS in the order
    graphed, eager, eager, graphed, graphed, eager; requests/s, host
    clock."""
    from repro_torch.serve import IMPACTEngine
    lits = digit_literals(1024, seed=SEED + 7)
    burst = np.tile(lits, (GRAPH_ENGINE_REQUESTS // len(lits), 1))
    rates = {}
    for m in ("off", "fused", "staged"):
        sess = served[f"engine_{m}"]["engine"].session
        engines = {"graphed": IMPACTEngine(sess, clock=time.perf_counter),
                   "eager": IMPACTEngine(EagerSession(sess),
                                         clock=time.perf_counter)}
        got = {k: [] for k in engines}
        for eng in engines.values():
            eng.run(lits[:2 * CAPACITY])
        for way in ("graphed", "eager", "eager", "graphed", "graphed",
                    "eager"):
            t0 = time.perf_counter()
            p, _ = engines[way].run(burst)
            got[way].append(len(p) / (time.perf_counter() - t0))
        rates[m] = got
        med = {w: statistics.median(v) for w, v in got.items()}
        print(f"phase 10 (h) IMPACTEngine metering={m}: requests/s graphed "
              + " / ".join(f"{r:.1f}" for r in got["graphed"])
              + f" (median {med['graphed']:.1f}), eager body "
              + " / ".join(f"{r:.1f}" for r in got["eager"])
              + f" (median {med['eager']:.1f}), "
              f"{med['graphed'] / med['eager']:.2f}x "
              f"({GRAPH_ENGINE_REQUESTS} requests a window); {card}")
    return rates


def graph_path(served: dict, trained: dict, compressed: dict,
               coresident: dict, card: str) -> dict:
    """Phase 10: every prepared entry of phases 4, 6 and 8 and the
    trainer's session is one CUDA graph, held to its eager body: (a)
    bitwise at its batches and at GRAPH_BATCHES on literals that fire
    clauses, (b) a result survives the next call, (c) refreshed operands
    are read, (d) nothing is prepared again (here, and over phase 4's
    bursts), (e) launches counted a call as eagerly, (f) no host sync,
    (g) ``audit()`` ok with the graph check; (h) host walls and
    requests/s, graphed against the eager body."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 110)
    for m, (a, b) in served["burst_traces"].items():
        if a != b:
            fail(f"(d) phase 4's bursts, metering={m}, prepared entries: "
                 f"trace_count {a} -> {b}")
    sessions = {id(s): s for sys_ in (served["system"], compressed["system"])
                for s in sys_._sessions.values()}
    online = trained["online_session"]
    sessions[id(online)] = online
    for s in coresident["sessions"]:
        sessions[id(s)] = s
    sessions = [s for s in sessions.values() if s.compiled_shapes()]
    keys = graph_entries(sessions)
    for sess, e, b in keys:
        sess.warm(b, e)
    traces = {id(s): s.trace_count for s in sessions}
    checked = check_graphs(keys, rng)
    backends = sorted({s.spec.backend for s in sessions})
    print(f"phase 10 (a), (b), (e), (f): {len(keys)} graphed entries of "
          f"{len(sessions)} sessions (backends {', '.join(backends)}; "
          f"packings, meterings and co-resident specs of phases 4, 6 and 8 "
          f"and the trainer's) equal their eager bodies bit for bit, keep "
          f"their results over the next call, count {checked['launches']} "
          f"launches as the eager calls do, and sync nothing; predict "
          f"lanes with a nonzero score: min {checked['fired'][0]:.3f} at "
          f"B >= 8, median {checked['fired'][1]:.3f}")
    refresh_check(trained, rng)

    nodes: dict[str, int] = {}
    audited = 0
    for sess in sessions:
        report = sess.audit()
        audited += len(report.fingerprints)
        if not report.ok:
            fail(f"(g) audit of {sess!r}: "
                 + "; ".join(str(f) for f in report.findings))
        for e, b in sess.compiled_shapes():
            g = sess.graph(e, b)
            if g is not None:
                key = f"{sess.spec.backend} {sess.route(e)}"
                nodes[key] = max(nodes.get(key, 0), g.census.port_kernels)
                if (e, b) == sess.compiled_shapes()[0]:
                    print(f"  {sess.spec.backend}/{sess.spec.metering}/"
                          f"{sess.spec.packing}"
                          + ("/co-resident" if sess.coresident else "")
                          + f" {e}@{b}: {g.census.describe()}")
    print(f"phase 10 (g): audit() ok on {audited} prepared entries with the "
          f"graph check; most port kernel nodes a graph by route: "
          + ", ".join(f"{k} {v}" for k, v in sorted(nodes.items())))
    walls = graph_walls(served["system"], card)
    rates = engine_rates(served, card)
    moved = {repr(s): (traces[id(s)], s.trace_count) for s in sessions
             if s.trace_count != traces[id(s)]}
    if moved:
        fail(f"(d) entries prepared again during phase 10: {moved}")
    print(f"phase 10 (d): trace_count unchanged on {len(sessions)} sessions "
          f"over the phase and on phase 4's over its bursts")
    print(f"phase graphs: done in {time.perf_counter() - t0:.1f} s")
    return dict(walls=walls, rates=rates)


# -- phase 11 -------------------------------------------------------------

# The sharded crossbar (Fig. 14 over torch.distributed): gloo worlds of
# SHARD_WORLDS ranks, every rank on the one card, model axis 2 (world 4:
# data 2 x model 2).  The paper-width model of phase 4 (seeded, untrained)
# on ideal devices at three placements: (tile rows, tile columns, class
# rows) -> (R, C, S) and the plan on a model axis of 2.
SHARD_WORLDS = (2, 4)
SHARD_MODEL = 2
SHARD_PLACEMENTS = {
    "both": ((512, 128, 128), (4, 4, 4), (True, True)),
    "r-only": ((512, 128, 2048), (4, 4, 1), (True, False)),
    # The reference's Fig. 14 tile (examples/crossbar_scaling.py:45).
    "s-only": ((128, 64, 64), (13, 8, 8), (False, True)),
}
SHARD_INVALID_EVERY = 16        # every 16th lane of a sweep is free
SHARD_REQUESTS = 256            # the engine's trace on each rank
SHARD_REPLAY_RATE = 2000.0      # its Poisson arrivals a second
SHARD_WALL_SWEEPS = 30          # host-wall samples a (session, batch)
RTOL_SHARD_METER = 1e-5         # lane meters, sharded vs one device


def identity_class(S: int, sr: int, n: int, device) -> torch.Tensor:
    """A class operand (S, sr, n) whose column j reads clause row j with a
    unit current: the class stage's scores are then the fired bits."""
    eye = torch.zeros((S * sr, n), dtype=torch.float32, device=device)
    k = min(S * sr, n)
    idx = torch.arange(k, device=device)
    eye[idx, idx] = 1.0
    return eye.reshape(S, sr, n)


def shard_bits_check(system, mesh, lits: torch.Tensor) -> int:
    """CSA bits through the sharded lowering (the identity class operand)
    against the single-device staged kernels on the card, f32 currents
    and 2-bit codes: exact.  Returns the fired bits counted."""
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels import backends, ops, packing
    R, C, tr, tc = system.clause_i.shape
    S, sr, _ = system.class_i.shape
    eye = identity_class(S, sr, C * tc, lits.device)
    ne = system._nonempty_eff()
    want, _ = system.clause_bits(lits)
    got = ops.fused_impact(lits, system.clause_i, ne, eye, thresh=TH,
                           mesh=mesh)
    exact("sharded CSA bits", got, want.to(torch.float32))
    pk = packing.pack_clause_operand(system.clause_i)
    want_pk, _ = backends.get_backend("cuda").impact_clause_bits(
        lits, packing.dequant_clause(pk.bits, pk.levels, tr), ne,
        thresh=TH)
    got_pk = ops.fused_impact_packed(lits, pk, ne, eye, thresh=TH, tr=tr,
                                     mesh=mesh)
    exact("sharded CSA bits, 2-bit", got_pk, want_pk.to(torch.float32))
    return int(want.sum())


def shard_gates(tag: str, sharded, single, lits, buf, valid) -> dict:
    """One (packing, metering) on the mesh against the same spec on one
    device: predictions (ties as in phase 8), scores, free lanes, lane
    meters and the report.  Returns the sharded session's calls, for the
    launch tally, and the ties."""
    res = {}
    with path_launches(res) as got:
        ps = sharded.predict(lits)
        rs = sharded.infer_step(buf, valid)
        rep = (sharded.infer_with_report(buf, valid).report
               if sharded.meters_energy else None)
    B = lits.shape[0]
    entries = ["predict", "infer_step"] + (["infer_with_report"]
                                           if rep is not None else [])
    priced = [sum(i.kernel == "crossbar_mvm_f32" for i in
                  sharded.work_items(e, B)) for e in entries]
    p1, r1 = single.predict(lits), single.infer_step(buf, valid)
    ties = gate_predictions(f"{tag} predict", ps.predictions, p1.predictions,
                            p1.scores)
    allclose(f"{tag} scores", ps.scores, p1.scores, RTOL_SCORES)
    free = ~valid
    exact(f"{tag} free lanes", rs.predictions[free],
          torch.full_like(rs.predictions[free], -1))
    ties += gate_predictions(f"{tag} infer_step", rs.predictions[valid],
                             r1.predictions[valid], p1.scores[valid])
    for name, a, b in (("clause", rs.e_clause_lanes, r1.e_clause_lanes),
                       ("class", rs.e_class_lanes, r1.e_class_lanes)):
        allclose(f"{tag} {name} lane energy", a, b, RTOL_SHARD_METER)
        if bool((a[free] != 0).any()):
            fail(f"{tag}: a free lane billed {name} energy")
    if rep is not None:
        rep1 = single.infer_with_report(buf, valid).report
        for f in ("read_energy_j", "clause_energy_j", "class_energy_j"):
            a, b = getattr(rep, f), getattr(rep1, f)
            if not abs(a - b) <= RTOL_SHARD_METER * abs(b):
                fail(f"{tag} report {f}: {a} against {b}")
        if rep.datapoints != rep1.datapoints:
            fail(f"{tag} report datapoints {rep.datapoints} against "
                 f"{rep1.datapoints}")
    return dict(launches=got.get("crossbar_mvm_f32", 0),
                priced=sum(priced), ties=ties)


def shard_graphs(tag: str, sharded, lits, buf, valid) -> int:
    """Every prepared serving entry of a sharded session is a
    ``StagedEntry`` of three captured stages, and one more call of each
    returns its eager body's outputs bit for bit (the same stages run
    eagerly, the all-reduces between them).  Returns the entries held."""
    from repro_torch.impact import graphs
    held = 0
    for entry, B in sharded.compiled_shapes():
        g = sharded.graph(entry, B)
        if not isinstance(g, graphs.StagedEntry) or len(g.stages) != 3:
            fail(f"{tag} {entry}@{B}: not three captured stages ({g!r})")
        if sharded.eager_reason(entry, B) is not None:
            fail(f"{tag} {entry}@{B}: {sharded.eager_reason(entry, B)}")
        args = [lits] if entry == "predict" else [buf, valid]
        args = [a.to(d) for a, (_, d) in zip(args,
                                             sharded.input_specs(entry, B))]
        got = g(*args)
        want = sharded.entry_fn(entry)(*args)
        for i, (a, b) in enumerate(zip(got, want)):
            exact(f"{tag} {entry}@{B} output {i}, graphed vs eager", a, b)
        held += 1
    return held


def shard_device_launches(sessions, buf, valid) -> tuple[int, int]:
    """One ``infer_step`` of each session under ``torch.profiler``: the
    device kernels of ``crossbar_mvm.cu`` it ran, against the launches
    its ``cost_analysis`` prices."""
    from repro_torch.analysis.profile_window import device_profile
    priced = 0
    with device_profile() as prof:
        for s in sessions:
            s.infer_step(buf, valid)
            priced += int(s.cost_analysis("infer_step",
                                          buf.shape[0])["launches"])
        torch.cuda.synchronize()
    kern, calls = pass_times(prof)
    ran = sum(n for k, n in calls.items() if "mvm_" in k)
    return ran, priced


def shard_walls(system, mesh) -> dict:
    """Host walls (median of SHARD_WALL_SWEEPS, synchronized) of
    ``predict`` and ``infer_step`` (fused metering) at COST_BATCHES,
    numpy literals in: the sharded session (its staged graphs), its
    entries' eager body (the same stages and all-reduces run eagerly,
    the operands moved to the card as an eager entry moves them) and the
    single-device session on the card.  The ranks start each sharded
    measurement together; the single-device one runs on the first rank
    alone while the others wait, so that it shares the card and the host
    with nothing."""
    import torch.distributed as dist
    from repro_torch.impact import RuntimeSpec, Topology
    lits = digit_literals(max(COST_BATCHES), seed=SEED + 13)
    valid = np.ones(max(COST_BATCHES), bool)
    walls = {}
    for entry, m in (("predict", "off"), ("infer_step", "fused")):
        spec = RuntimeSpec(backend="cuda", metering=m,
                           device=str(system.device))
        for way, topo in (("sharded", Topology(mesh=mesh)),
                          ("one device", Topology(shard="none"))):
            sess = system.compile(dataclasses.replace(spec, topology=topo))
            alone = way == "one device"
            for B in COST_BATCHES:
                args = [lits[:B]] + ([valid[:B]] if entry != "predict"
                                     else [])
                fn = getattr(sess, entry)
                dist.barrier()
                if not alone or dist.get_rank() == 0:
                    walls[f"{entry}/{way}/{B}"] = host_sweep_s(
                        lambda: fn(*args), SHARD_WALL_SWEEPS)
                if alone:
                    dist.barrier()
                    continue
                body = sess.entry_fn(entry)
                dtypes = [d for _, d in sess.input_specs(entry, B)]

                def eager():
                    return body(*(torch.as_tensor(x, device=system.device)
                                  .to(d) for x, d in zip(args, dtypes)))

                dist.barrier()
                walls[f"{entry}/eager/{B}"] = host_sweep_s(
                    eager, SHARD_WALL_SWEEPS)
    return walls


def shard_world(rank: int, out_dir: str, device: str) -> None:
    """Phase 11 on one rank of a gloo world: every rank drives the same
    calls on the card and gates its own results, written to
    ``w<world>_rank<rank>.json``."""
    import torch.distributed as dist
    from repro_torch.impact import (IMPACTConfig, RuntimeSpec, Topology,
                                    build_system)
    from repro_torch.launch.mesh import make_crossbar_mesh
    from repro_torch.serve import IMPACTEngine
    from repro_torch.serve.impact_engine import poisson_arrivals, replay_trace
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    world = dist.get_world_size()
    clock = {"start": time.perf_counter()}
    mesh = make_crossbar_mesh(SHARD_MODEL, device_type=dev.type)
    params, cfg = seeded_params()
    lits = torch.as_tensor(digit_literals(CAPACITY, seed=SEED + 12),
                           device=dev)
    valid = torch.ones(CAPACITY, dtype=torch.bool, device=dev)
    valid[::SHARD_INVALID_EVERY] = False
    buf = torch.where(valid[:, None], lits, torch.ones_like(lits))
    out = dict(rank=rank, world=world, placements={})
    tally = dict(launches=0, priced=0, ties=0, graphed=0)
    sessions = []
    clock["setup"] = time.perf_counter()
    for name, (tiles, grid, plan) in SHARD_PLACEMENTS.items():
        tr, tc, sr = tiles
        system = build_system(params, cfg, None, IMPACTConfig(
            variability=False, max_tile_rows=tr, max_tile_cols=tc,
            max_class_rows=sr), device=dev)
        got_grid = (system.clause_i.shape[0], system.clause_i.shape[1],
                    system.class_i.shape[0])
        if got_grid != grid:
            fail(f"placement {name}: grid {got_grid}, expected {grid}")
        fired = shard_bits_check(system, mesh, lits)
        audited = 0
        for pk in ("none", "2bit"):
            for m in ("off", "staged", "fused"):
                spec = RuntimeSpec(backend="cuda", metering=m, packing=pk,
                                   capacity=CAPACITY, device=str(dev))
                single = system.compile(dataclasses.replace(
                    spec, topology=Topology(shard="none")))
                sharded = system.compile(dataclasses.replace(
                    spec, topology=Topology(mesh=mesh)))
                if sharded.plan != plan:
                    fail(f"placement {name}: plan {sharded.plan}, "
                         f"expected {plan}")
                g = shard_gates(f"{name} {pk} {m}", sharded, single, lits,
                                buf, valid)
                g["graphed"] = shard_graphs(f"{name} {pk} {m}", sharded,
                                            lits, buf, valid)
                for k in tally:
                    tally[k] += g[k]
                sessions.append(sharded)
                if m == "staged" or (m == "fused" and pk == "2bit"):
                    report = sharded.audit()
                    if not report.ok:
                        fail(f"audit of {name} {pk} {m}: "
                             + "; ".join(str(f) for f in report.findings))
                    audited += 1
                if sharded.trace_count != (3 if m != "off" else 2):
                    fail(f"{name} {pk} {m}: {sharded.trace_count} "
                         f"prepared entries")
        out["placements"][name] = dict(
            grid=got_grid, plan=list(plan), fired_bits=fired,
            audited=audited, lanes=sessions[-1].local_batch(CAPACITY),
            calls_per_sweep=[len(sessions[-6].mvm_calls()),
                             len(sessions[-1].mvm_calls())])
        clock[name] = time.perf_counter()
        if name == "both":
            session = system.compile(RuntimeSpec(
                backend="cuda", capacity=CAPACITY, device=str(dev),
                topology=Topology(mesh=mesh)))
            # replay_trace on the wall clock: every reading is rank 0's
            # time.monotonic(), so every rank admits the same sweeps.
            eng = IMPACTEngine(session, clock=time.monotonic)
            reqs = digit_literals(SHARD_REQUESTS, seed=SEED + 14)
            arrivals = poisson_arrivals(SHARD_REQUESTS, SHARD_REPLAY_RATE,
                                        seed=SEED + 15)
            traces = session.trace_count
            with path_launches({}) as got:
                res = replay_trace(eng, reqs, arrivals)
            if session.trace_count != traces:
                fail(f"replay_trace prepared {session.trace_count - traces}"
                     f" entries")
            tally["launches"] += got["crossbar_mvm_f32"]
            tally["priced"] += sum(
                sum(i.kernel == "crossbar_mvm_f32"
                    for i in session.work_items("infer_step", CAPACITY))
                for _ in eng.batch_stats)
            recs = sorted(eng.request_records, key=lambda r: r.rid)
            if (res["completed"], res["shed"], len(recs)) != (
                    SHARD_REQUESTS, 0, SHARD_REQUESTS):
                fail(f"replay_trace completed {res['completed']}, shed "
                     f"{res['shed']}, {len(recs)} records")
            preds = [r.pred for r in recs]
            direct = system.compile(RuntimeSpec(
                backend="cuda", metering="off", device=str(dev),
                topology=Topology(shard="none"))).predict(reqs)
            gate_predictions("engine", torch.as_tensor(preds),
                             direct.predictions, direct.scores)
            bills = [r.e_read_j for r in recs]
            meter = sum(r.read_energy_j for r in eng.reports)
            if not abs(sum(bills) - meter) <= RTOL_BILLS * abs(meter):
                fail(f"engine bills {sum(bills)} against the batch meter "
                     f"{meter}")
            out["engine"] = dict(
                sweeps=len(eng.batch_stats), bills=sum(bills), meter=meter,
                same=dict(preds=preds, bills=bills, completed=res[
                    "completed"], shed=res["shed"], wall_s=res["wall_s"],
                    p50_s=res["p50_s"], p99_s=res["p99_s"]))
            clock["engine"] = time.perf_counter()
            out["walls"] = shard_walls(system, mesh)
            clock["walls"] = time.perf_counter()
    ran, priced = shard_device_launches(sessions, buf, valid)
    if ran != priced:
        fail(f"{ran} crossbar_mvm device kernels in one infer_step of each "
             f"sharded session, cost_analysis prices {priced}")
    out["device_launches"] = ran
    clock["profile"] = time.perf_counter()
    if tally["launches"] == 0:
        fail("the sharded path launched crossbar_mvm no time")
    if tally["launches"] != tally["priced"]:
        fail(f"{tally['launches']} crossbar_mvm calls, cost_analysis "
             f"prices {tally['priced']}")
    out["tally"] = tally
    marks = list(clock.items())
    out["seconds"] = {k: round(t - t0, 2)
                      for (_, t0), (k, t) in zip(marks, marks[1:])}
    with open(os.path.join(out_dir, f"w{world}_rank{rank}.json"),
              "w") as f:
        json.dump(out, f)


def sharded_rank(rank: int, out_dir: str, device: str = "cuda") -> None:
    """Phase 11 on one process (``launch.mesh.spawn``): the world of the
    largest of SHARD_WORLDS, then the first ranks regroup as each smaller
    world in turn, so the processes start (and reach the card) once."""
    import datetime
    import gc
    import torch.distributed as dist
    from repro_torch.launch.mesh import TIMEOUT_S
    for i, world in enumerate(sorted(SHARD_WORLDS, reverse=True)):
        if i:
            gc.collect()                # sessions holding the old mesh
            dist.destroy_process_group()
            if rank >= world:
                return
            dist.init_process_group(
                "gloo", init_method=f"file://{out_dir}/store{world}",
                rank=rank, world_size=world,
                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        shard_world(rank, out_dir, device)


def sharded_path(card: str) -> dict:
    """Phase 11: the sharded crossbar over gloo worlds of SHARD_WORLDS
    ranks on the one card; any rank's failure fails the phase."""
    import tempfile
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        spawn(sharded_rank, max(SHARD_WORLDS), tmp,
              init_method=f"file://{tmp}/store")
        for world in SHARD_WORLDS:
            results[world] = []
            for r in range(world):
                with open(os.path.join(tmp, f"w{world}_rank{r}.json")) as f:
                    results[world].append(json.load(f))
    launches = 0
    for world, ranks in results.items():
        for r in ranks[1:]:
            if r["engine"]["same"] != ranks[0]["engine"]["same"]:
                fail(f"phase 11 world {world}: rank {r['rank']}'s replay "
                     f"differs from rank 0's")
        same = ranks[0]["engine"]["same"]
        print(f"phase 11 world {world}: replay_trace of {SHARD_REQUESTS} "
              f"Poisson arrivals at {SHARD_REPLAY_RATE:.0f}/s on rank 0's "
              f"clock, every rank the same: {same['completed']} completed, "
              f"{same['shed']} shed, wall {same['wall_s']:.4f} s, latency "
              f"p50 {same['p50_s'] * 1e3:.4f} ms p99 "
              f"{same['p99_s'] * 1e3:.4f} ms")
        for r in ranks:
            t = r["tally"]
            launches += t["launches"]
            print(f"phase 11 world {world} rank {r['rank']}: "
                  f"{t['launches']} crossbar_mvm calls on the sharded path "
                  f"(cost_analysis prices {t['priced']}), "
                  f"{r['device_launches']} device kernels of crossbar_mvm.cu "
                  f"in one infer_step a session, as priced; "
                  f"{t['graphed']} staged graph entries equal to their eager "
                  f"bodies bit for bit; {t['ties']} "
                  f"tied predictions; engine {r['engine']['sweeps']} "
                  f"sweeps, bills {r['engine']['bills']:.6e} J against "
                  f"{r['engine']['meter']:.6e} J; "
                  + "; ".join(f"{n}: grid {p['grid']}, plan {p['plan']}, "
                              f"{p['calls_per_sweep']} calls a sweep (f32, "
                              f"2-bit) on "
                              f"{p['lanes']} lanes, {p['fired_bits']} fired "
                              f"bits exact, {p['audited']} sessions audited"
                              for n, p in r["placements"].items())
                  + f"; seconds {r['seconds']}")
        walls = ranks[0]["walls"]
        for entry in ("predict", "infer_step"):
            for B in COST_BATCHES:
                sh = max(r["walls"][f"{entry}/sharded/{B}"] for r in ranks)
                ea = max(r["walls"][f"{entry}/eager/{B}"] for r in ranks)
                one = walls[f"{entry}/one device/{B}"]
                print(f"phase 11 world {world} {entry} B={B}: host wall "
                      f"sharded graphed {sh * 1e3:.4f} ms, eager "
                      f"{ea * 1e3:.4f} ms (slowest rank each), one "
                      f"device {one * 1e3:.4f} ms (rank 0 alone, graphed), "
                      f"graphed {sh / one:.1f}x one device, eager "
                      f"{ea / sh:.2f}x graphed; medians of "
                      f"{SHARD_WALL_SWEEPS}; {card}")
    print(f"phase sharded path: done in {time.perf_counter() - t0:.1f} s; "
          f"{launches} crossbar_mvm launches on the sharded path")
    results["launches"] = launches
    return results


# -- phase 12 --------------------------------------------------------------

# (a) llama3-8b at full width and depth: prefill LM_BATCH prompts of
# LM_PROMPT tokens into a cache of LM_MAX_LEN, then LM_DECODE greedy
# steps; prefill timed again LM_TIMED_PREFILLS times.  Its first
# LM_CPU_LAYERS layers with embedding and head, in bf16, run the same
# prefill and decode steps, held to forward.  (b) those layers in f32 on
# the card and on the CPU at B = 1, S = LM_CPU_TOKENS.  (c) the TM head on
# (a)'s pooled prompt states (TMHeadConfig() defaults: K = 2 x 4096
# literals), then TM_STEPS training steps on TM_SEQS sequences of TM_LEN
# tokens in two classes.  (d) the other transformer-family configs at
# full width, one layer deep (deepseek: its dense front layer and one MoE
# layer), prefill OTHER_BATCH x OTHER_PROMPT (qwen2-vl after OTHER_IMAGE
# patch embeddings), OTHER_DECODE greedy steps.
LM_ARCH = "llama3-8b"
LM_BATCH, LM_PROMPT, LM_DECODE, LM_MAX_LEN = 4, 512, 16, 1024
LM_TIMED_PREFILLS = 3
LM_CPU_LAYERS, LM_CPU_TOKENS = 2, 32
OTHER_BATCH, OTHER_PROMPT, OTHER_DECODE, OTHER_IMAGE = 2, 128, 2, 16
# The head's training data: class c draws 95% of its tokens from its own
# TM_CLASS_TOKENS token ids.  (The reference test's recipe, which vocab
# half dominates, carries no signal at V = 128256: the two halves' mean
# embeddings differ by about 1/sqrt(V/2) a feature.)
TM_SEQS, TM_LEN, TM_STEPS, TM_CLASS_TOKENS = 96, 48, 60, 64
# Chance is 0.5; 0.65 is three standard deviations of a fair coin over
# TM_SEQS sequences above it.
TM_CHANCE_ACC = 0.65
# (median, p99, max) of |got - want| / max |want| over the compared
# logits, and the least share of positions whose argmax agrees (every
# other one must be a tie its own row's error explains).  (b) holds f32
# on the card to f32 on the CPU with the CPU tests' f32 bounds
# (tests/test_torch_models.py: the same mechanism, a rounding step of the
# bf16 q / k / probabilities that the init's one-hot attention carries).
# LM_DECODE_BOUNDS hold bf16 decode to forward: (a)'s first
# LM_CPU_LAYERS layers and (d)'s one-layer models.  LM_LAYER_BOUNDS hold
# each layer's teacher-forced decode step to the forward's output of that
# layer (hidden states, relative to the layer's largest), about 3x the
# largest gaps measured on the H100 (median 2.2e-3, p99 1.1e-2, max
# 2.0e-2, deepseek's MoE layer).  At (a)'s full depth decode and forward
# are not compared under a bound: the init's nearly one-hot attention
# lets one rounding step grow over 32 layers until the two are
# uncorrelated, as forward is with itself under another key chunking;
# the gap is printed as a note.
LM_CPU_BOUNDS, LM_CPU_ARGMAX = (3e-5, 1e-2, 1e-1), 1.0
LM_DECODE_BOUNDS, LM_DECODE_ARGMAX = (3e-2, 1.5e-1, 3e-1), 0.5
LM_LAYER_BOUNDS = (1e-2, 3e-2, 6e-2)


def rel_stats(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Median, p99 and max of |got - want| / max |want| (f64)."""
    got, want = got.double(), want.double()
    rel = ((got - want).abs() / want.abs().max()).flatten().sort().values
    n = rel.numel()
    return dict(median=float(rel[n // 2]),
                p99=float(rel[int(0.99 * (n - 1))]), max=float(rel[-1]))


def lm_gate(name: str, got: torch.Tensor, want: torch.Tensor,
            bounds: tuple, min_share: float) -> dict:
    """Hold logits ``got`` to ``want`` (same shape, vocab last): the
    median, p99 and max of |got - want| / max |want| within ``bounds``,
    argmax equal at ``min_share`` of the positions or more and every
    other position a tie (the reference's top exceeds its logit at
    ``got``'s argmax by at most twice the row's max error)."""
    got, want = got.double(), want.double()
    if got.shape != want.shape:
        fail(f"{name}: shapes {tuple(got.shape)} and {tuple(want.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{name}: logits not finite")
    err = (got - want).abs()
    stats = rel_stats(got, want)
    g, w = got.argmax(-1), want.argmax(-1)
    gap = want.amax(-1) - torch.gather(want, -1, g[..., None])[..., 0]
    tie = gap <= 2 * err.amax(-1)
    share = float((g == w).double().mean())
    print(f"  {name}: rel err median {stats['median']:.3e} p99 "
          f"{stats['p99']:.3e} max {stats['max']:.3e} (bounds "
          f"{bounds}); argmax equal at {share:.4f} of {g.numel()} "
          f"positions, {int(((g != w) & tie).sum())} ties")
    for k, b in zip(("median", "p99", "max"), bounds):
        if not stats[k] <= b:
            fail(f"{name}: {k} rel err {stats[k]:.3e} > {b}")
    if not bool(((g == w) | tie).all()):
        fail(f"{name}: argmax differs at {int(((g != w) & ~tie).sum())} "
             f"positions that are not ties")
    if share < min_share:
        fail(f"{name}: argmax agrees at {share:.4f} < {min_share}")
    return dict(stats, argmax_share=share)


def lm_inputs(cfg, B: int, S: int, rng, n_img: int = 0):
    """Prompt tokens, positions and (vlm) patch embeddings on the host:
    an n_img patch grid at t = 0 before the text for M-RoPE."""
    shape = (B, S, cfg.n_codebooks) if cfg.modality == "audio" else (B, S)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, shape))
    extra = None
    if cfg.rope_style == "mrope":
        side = int(np.sqrt(n_img))
        i = np.arange(n_img)
        grid = np.stack([np.zeros(n_img), i // side, i % side])
        text = np.broadcast_to(np.arange(S) + side, (3, S))
        pos = np.concatenate([grid, text], 1)
        positions = torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(pos[:, None], (3, B, n_img + S)))).long()
        extra = torch.from_numpy(rng.standard_normal(
            (B, n_img, cfg.d_model)).astype(np.float32))
    else:
        positions = torch.arange(S).expand(B, S).contiguous()
    return tokens, positions, extra


def greedy(model, tokens, positions, extra, max_len: int,
           steps: int) -> dict:
    """Prefill, then ``steps`` greedy decode steps, each step and the
    prefill between CUDA events."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 + 2 * steps)]
    ev[0].record()
    logits, cache = model.prefill(tokens, positions, max_len, extra)
    ev[1].record()
    first = logits
    nxt = logits.argmax(-1)
    last = positions[..., -1:]
    fed, out = [], []
    for t in range(steps):
        fed.append(nxt)
        ev[2 + 2 * t].record()
        logits, cache = model.decode_step(cache, nxt, last + 1 + t)
        ev[3 + 2 * t].record()
        out.append(logits)
        nxt = logits.argmax(-1)
    torch.cuda.synchronize()
    return dict(cache=cache, fed=torch.cat(fed, 1) if fed else None,
                prefill_logits=first,
                decode_logits=torch.cat(out, 1) if out else None,
                prefill_ms=ev[0].elapsed_time(ev[1]),
                step_ms=[ev[2 + 2 * t].elapsed_time(ev[3 + 2 * t])
                         for t in range(steps)])


def check_cache_len(name: str, cache: dict, want: int) -> None:
    """Every layer's cache length (front layers too) equals ``want``."""
    lens = {"layers": cache["layers"]["len"],
            **{f"front {i}": c["len"]
               for i, c in enumerate(cache.get("front", []))}}
    for k, v in lens.items():
        if not bool((v == want).all()):
            fail(f"{name}: cache len of {k} is {v.tolist()}, want {want}")


def extended(run: dict, tokens, positions):
    """The prompt extended by the tokens the decode steps were fed, and
    its positions."""
    T = run["fed"].shape[1]
    last = positions[..., -1:]
    return (torch.cat([tokens, run["fed"]], 1),
            torch.cat([positions, last + 1 + torch.arange(
                T, device=positions.device)], -1))


def decode_per_layer(name: str, model, ext, pos_ext, extra, n_prompt: int,
                     steps: tuple, max_len: int) -> dict:
    """Teacher-forced decode against forward, layer by layer: each layer
    takes the forward's own input to it, prefills the first n_prompt + t
    positions into its cache and decodes position n_prompt + t; the
    output is held to the forward's output of that layer at that position
    (``LM_LAYER_BOUNDS``, relative to the layer's largest output).  One
    layer's rounding, not the depth's, sets the gap."""
    x = model.embed(ext, extra)
    blocks = [(p, False) for p in (model.params["front"]
                                   if "front" in model.params else ())]
    blocks += [(p, model.cfg.moe is not None) for p in model.params["layers"]]
    decs, wants = [], []
    with torch.no_grad():
        for p, moe in blocks:
            out, _, _ = model._block(p, x, pos_ext, moe_layer=moe)
            for t in steps:
                n = n_prompt + t
                _, _, cache = model._block(p, x[:, :n], pos_ext[..., :n],
                                           moe_layer=moe, fill_len=max_len)
                dec, _, cache = model._block(p, x[:, n:n + 1],
                                             pos_ext[..., n:n + 1],
                                             moe_layer=moe, cache=cache)
                if not bool((cache["len"] == n + 1).all()):
                    fail(f"{name}: a layer's cache len {cache['len']}, "
                         f"want {n + 1}")
                decs.append(dec)
                wants.append(out[:, n:n + 1])
            x = out
    return layer_gate(name, decs, wants, f"decode vs forward, "
                      f"teacher-forced, {len(blocks)} layers x steps {steps}")


def layer_gate(name: str, got: list, want: list, what: str) -> dict:
    """Hold each layer output in ``got`` to its counterpart in ``want``
    (``LM_LAYER_BOUNDS``), each gap relative to the largest value of that
    layer output in ``want``; ``what`` names the comparison."""
    rel = lambda x, w: (x.double() / w.double().abs().amax()).flatten()
    stats = rel_stats(torch.cat([rel(g, w) for g, w in zip(got, want)]),
                      torch.cat([rel(w, w) for w in want]))
    print(f"  {name} {what}: rel err median {stats['median']:.3e} p99 "
          f"{stats['p99']:.3e} max {stats['max']:.3e} (bounds "
          f"{LM_LAYER_BOUNDS})")
    for k, b in zip(("median", "p99", "max"), LM_LAYER_BOUNDS):
        if not stats[k] <= b:
            fail(f"{name}: {what}: {k} rel err {stats[k]:.3e} > {b}")
    return stats


def moe_no_drop(cfg):
    """Capacity factor E / top_k, so C = S and no token is dropped: with
    drops a token's output depends on the other tokens of its group
    (GShard capacity), and a one-token decode step (C >= 1) keeps what a
    130-token forward drops, so decode and forward would differ by
    design, not by rounding."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def tm_head_params(K_: int, n: int, m: int, n_states: int, seed: int,
                   device):
    """Head parameters where each clause includes 1 to 6 literals (so
    clauses fire on booleanized features), integer weights in [-40, 40)."""
    from repro_torch.convert import params_from_arrays
    rng = np.random.default_rng(seed)
    ta = np.full((K_, n), n_states, np.int32)
    for j in range(n):
        ta[rng.choice(K_, int(rng.integers(1, 7)), replace=False), j] += 1
    return params_from_arrays(ta, rng.integers(-40, 40, (m, n)),
                              device=device)


def head_scores(name: str, head, params, feats) -> tuple:
    """``head.scores`` on the card, required to equal ``fused_cotm_ref``
    on the same literals, include mask, nonempty mask (a clause with no
    include never fires, as ``kernels.ops`` sets it) and weights bit for
    bit; returns the scores and their max abs difference."""
    from repro_torch.kernels import ref
    scores = head.scores(params, feats)
    inc = params.ta_state > head.cfg.n_states
    want = ref.fused_cotm_ref(head.booleanize(feats).to(torch.int8), inc,
                              params.weights.T.contiguous(), inc.any(dim=0))
    exact(f"{name} vs fused_cotm_ref", scores, want)
    return scores, float((scores - want).abs().max())


def tm_training(model, device, gen) -> tuple[float, float]:
    """(c) TM_STEPS head steps on frozen full-width embeddings of two
    sequence classes; returns the accuracy on the training sequences,
    from scores held bit for bit to the plain version, and the scores'
    max abs difference from it."""
    from repro_torch.models import TMHead, TMHeadConfig, pool_features
    rng = np.random.default_rng(SEED + 120)
    V = model.cfg.vocab
    sets = rng.choice(V, 2 * TM_CLASS_TOKENS, replace=False).reshape(2, -1)
    y = rng.integers(0, 2, TM_SEQS)
    own = rng.random((TM_SEQS, TM_LEN)) < 0.95
    pick = rng.integers(0, TM_CLASS_TOKENS, (TM_SEQS, TM_LEN))
    toks = np.where(own, sets[y][np.arange(TM_SEQS)[:, None], pick],
                    sets[1 - y][np.arange(TM_SEQS)[:, None], pick])
    emb = model.params["embed"][torch.as_tensor(toks, device=device)]
    feats = pool_features(emb)
    head = TMHead(TMHeadConfig(n_classes=2, n_clauses=128,
                               bits_per_feature=6, threshold=24),
                  d_features=model.cfg.d_model)
    hp = head.init(gen)
    labels = torch.as_tensor(y, device=device)
    for _ in range(TM_STEPS):
        hp = head.train_step(hp, feats, labels, gen)
    scores, err = head_scores("trained TM head scores", head, hp, feats)
    return float((scores.argmax(-1) == labels).float().mean()), err


def lm_prefix(model, dtype: str, n_layers: int = LM_CPU_LAYERS):
    """A copy of ``model``'s first ``n_layers`` layers (zamba2: with the
    shared block after every full group of them) with its embedding and
    head, computing in ``dtype``."""
    from repro_torch.models import build
    from repro_torch.models.base import leaves
    cfg = dataclasses.replace(model.cfg, n_layers=n_layers, dtype=dtype)
    small = build(cfg, device=model.device)
    with torch.no_grad():
        for path, _ in leaves(small.decls()):
            dst, src = small.leaf(path), model.leaf(path)
            for d, s in (zip(dst, src) if path[0] == "layers"
                         else [(dst, src)]):
                d.copy_(s)
    return small


def prefix_decode(model, tokens, positions, n_layers: int = LM_CPU_LAYERS,
                  check=None) -> dict:
    """``decode_step`` threading the cache through several layers:
    ``model``'s first ``n_layers`` layers in its own compute dtype take
    the prefill of ``tokens`` and LM_DECODE greedy steps (their cache
    checked by ``check``, default ``check_cache_len``), and their logits
    are held to ``forward`` on the prompt extended by the tokens fed."""
    small = lm_prefix(model, model.cfg.dtype, n_layers)
    S = tokens.shape[1]
    run = greedy(small, tokens, positions, None, LM_MAX_LEN, LM_DECODE)
    label = f"{model.cfg.name} x {n_layers} layers"
    (check or check_cache_len)(label, run["cache"], S + LM_DECODE)
    ext, pos_ext = extended(run, tokens, positions)
    want = small.forward(ext, pos_ext)[0][:, S:S + LM_DECODE]
    return lm_gate(f"{label} {model.cfg.dtype} decode vs forward "
                   f"({LM_DECODE} steps)", run["decode_logits"], want,
                   LM_DECODE_BOUNDS, LM_DECODE_ARGMAX)


def cpu_parity(model, device, n_layers: int = LM_CPU_LAYERS) -> dict:
    """The first ``n_layers`` layers with embedding and head, f32, on the
    card and on the CPU, B = 1."""
    small = lm_prefix(model, "float32", n_layers)
    rng = np.random.default_rng(SEED + 121)
    tokens, positions, _ = lm_inputs(small.cfg, 1, LM_CPU_TOKENS, rng)
    on_card = small.forward(tokens.to(device), positions.to(device))[0]
    on_cpu = small.to("cpu").forward(tokens, positions)[0]
    return lm_gate(f"{model.cfg.name} x {n_layers} layers f32, card vs "
                   f"CPU", on_card.cpu(), on_cpu, LM_CPU_BOUNDS,
                   LM_CPU_ARGMAX)


def head_literals(name: str) -> int:
    """K of the CoTM head on ``name``'s pooled states (2 x d_model)."""
    from repro_torch.configs import get_config
    from repro_torch.models import TMHead, TMHeadConfig
    return TMHead(TMHeadConfig(), d_features=get_config(
        name).d_model).cotm_cfg.n_literals


def head_kernel_row(head, params, feats, launches: int, err: float,
                    name: str = "fused_cotm (TM head)") -> dict:
    """(e) ``fused_cotm`` at the head's shape: the kernel, its plain
    version and one PyTorch yardstick (the f32 two-matmul composition),
    with the bound of ``kernels/work.py::fused_cotm``."""
    from repro_torch.core.cotm import include_mask
    from repro_torch.kernels import ref
    from repro_torch.kernels import work as wk
    from repro_torch.kernels.fused_cotm import fused_cotm
    lit = head.booleanize(feats).to(torch.int8).contiguous()
    inc = include_mask(params.ta_state, head.cotm_cfg.n_states).contiguous()
    w = params.weights.T.contiguous()
    ne = inc.any(dim=0)
    B, Kl = lit.shape
    N, M = w.shape
    not_l, inc_f, w_f = 1.0 - lit.float(), inc.float(), w.float()

    def lib():
        fired = (torch.matmul(not_l, inc_f) == 0) & ne
        return torch.matmul(fired.float(), w_f)

    work = wk.fused_cotm(B, Kl, N, M)
    b_ms, b_by = bound_ms(work, int_ops=True)
    print(f"fused_cotm at the TM head's shape (B, K, N, M) = ({B}, {Kl}, "
          f"{N}, {M}): {work[0]:.0f} 0/1 operations on {work[1]:.0f} B")
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/digital_cotm.cu",
        replaces="src/repro/kernels/fused_cotm.py:40", launches=launches,
        max_abs_err=err, ms=cuda_ms(lambda: fused_cotm(lit, inc, w, ne)),
        plain_ms=cuda_ms(lambda: ref.fused_cotm_ref(lit, inc, w, ne)),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(lib))


def llama_path(device, card: str) -> tuple[dict, dict]:
    """(a)-(c) and (e) on llama3-8b at full width and depth."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import (TMHead, TMHeadConfig, build,
                                    pool_features)
    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device).manual_seed(SEED)
    t0 = time.perf_counter()
    model = build(cfg, device=device).init(gen)
    torch.cuda.synchronize()
    print(f"phase 12 (a) {LM_ARCH}: {model.n_params():,} parameters "
          f"({cfg.n_layers} layers, d {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, V {cfg.vocab}), "
          f"{cfg.param_dtype} weights, {cfg.dtype} compute, drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    rng = np.random.default_rng(SEED + 122)
    tokens, positions, _ = lm_inputs(cfg, LM_BATCH, LM_PROMPT, rng)
    tokens, positions = tokens.to(device), positions.to(device)
    head = TMHead(TMHeadConfig(), d_features=cfg.d_model)
    hparams = tm_head_params(head.cotm_cfg.n_literals, head.cfg.n_clauses,
                             head.cfg.n_classes, head.cfg.n_states,
                             SEED + 123, device)

    # The main path, in one launch-count window: prefill, greedy decode,
    # the head's scores on the pooled prompt states (B, K, N, M) = (4,
    # 8192, 500, 10), head training and the trained head's scores (96,
    # 49152, 128, 2); each scores call held bit for bit to fused_cotm_ref.
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    run = greedy(model, tokens, positions, None, LM_MAX_LEN, LM_DECODE)
    hidden, _ = model.hidden(tokens, positions)
    feats = pool_features(hidden)
    scores, err = head_scores("TM head scores", head, hparams, feats)
    acc, err_trained = tm_training(model, device, gen)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if launches["fused_cotm_i32"] == 0:
        fail("fused_cotm was never launched on the LM path")
    print(f"phase 12 main path: launches "
          f"{ {k: v for k, v in launches.items() if v} }; peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")

    if not torch.isfinite(run["decode_logits"]).all():
        fail(f"{LM_ARCH}: decode logits not finite")
    check_cache_len(LM_ARCH, run["cache"], LM_PROMPT + LM_DECODE)
    ext, pos_ext = extended(run, tokens, positions)
    dec = decode_per_layer(LM_ARCH, model, ext, pos_ext, None, LM_PROMPT,
                           (0, LM_DECODE - 1), LM_MAX_LEN)
    fwd = model.forward(ext, pos_ext)[0][:, LM_PROMPT:LM_PROMPT + LM_DECODE]
    dec["end_to_end"] = dict(rel_stats(run["decode_logits"], fwd), argmax=(
        float((run["decode_logits"].argmax(-1) == fwd.argmax(-1))
              .double().mean())))
    del fwd
    print(f"  {LM_ARCH} {cfg.n_layers} layers, decode vs forward (a note, "
          f"not gated): rel err median {dec['end_to_end']['median']:.3e} "
          f"p99 {dec['end_to_end']['p99']:.3e} max "
          f"{dec['end_to_end']['max']:.3e}; argmax equal at "
          f"{dec['end_to_end']['argmax']:.4f} of {LM_BATCH * LM_DECODE} "
          f"positions")
    dec["prefix"] = prefix_decode(model, tokens, positions)

    print(f"phase 12 (c) TM head on pooled {LM_ARCH} prompt states: K = "
          f"{head.cotm_cfg.n_literals} literals, {head.cfg.n_clauses} "
          f"clauses, {head.cfg.n_classes} classes; scores bitwise equal to "
          f"fused_cotm_ref on the card ({int((scores != 0).sum())} nonzero "
          f"of {scores.numel()}); training {TM_STEPS} steps on "
          f"{TM_SEQS} sequences of 2 classes (K = "
          f"{2 * cfg.d_model * 6}): accuracy {acc:.4f} from scores bitwise "
          f"equal to fused_cotm_ref (gate > {TM_CHANCE_ACC}, chance 0.5)")
    if not acc > TM_CHANCE_ACC:
        fail(f"TM head accuracy {acc:.4f} not above {TM_CHANCE_ACC}")

    # (e) times: prefill again, each decode step of the main path
    pre = [run["prefill_ms"]]
    for _ in range(LM_TIMED_PREFILLS):
        pre.append(greedy(model, tokens, positions, None, LM_MAX_LEN,
                          0)["prefill_ms"])
    p_ms, d_ms = statistics.median(pre), statistics.median(run["step_ms"])
    times = dict(prefill_ms=p_ms, prefill_tokens_s=LM_BATCH * LM_PROMPT
                 / (p_ms / 1e3), decode_step_ms=d_ms,
                 decode_tokens_s=LM_BATCH / (d_ms / 1e3), peak_gib=peak
                 / 2**30, acc=acc, decode=dec)
    print(f"phase 12 (e) {LM_ARCH} B={LM_BATCH}: prefill of {LM_PROMPT} "
          f"tokens {p_ms:.2f} ms ({times['prefill_tokens_s']:.1f} tokens/s;"
          f" median of {len(pre)}: "
          + ", ".join(f"{x:.2f}" for x in pre)
          + f"), decode step {d_ms:.3f} ms ({times['decode_tokens_s']:.1f} "
          f"tokens/s; median of {LM_DECODE}: "
          + ", ".join(f"{x:.2f}" for x in run["step_ms"])
          + f"); CUDA events; {card}")
    row = head_kernel_row(head, hparams, feats, launches["fused_cotm_i32"],
                          max(err, err_trained))
    print(f"{row['name']}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} "
          f"ms, library {row['library_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.5f} ms by {row['bound_by']}), "
          f"{row['launches']} launches on the path (one at each of the two "
          f"head shapes); {card}")
    times["cpu"] = cpu_parity(model, device)
    return times, row


def other_configs(device) -> dict:
    """(d) The other transformer-family configs at full width, one layer
    deep, one model on the card at a time."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import build
    out = {}
    for i, name in enumerate(ARCH_IDS):
        cfg = get_config(name)
        if cfg.ssm is not None or name == LM_ARCH:
            continue
        n_front = cfg.moe.first_dense_layers if cfg.moe else 0
        cfg = moe_no_drop(dataclasses.replace(cfg, n_layers=n_front + 1))
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model = build(cfg, device=device).init(
            torch.Generator(device).manual_seed(SEED + i))
        rng = np.random.default_rng(SEED + 130 + i)
        n_img = OTHER_IMAGE if cfg.rope_style == "mrope" else 0
        tokens, positions, extra = (
            None if x is None else x.to(device)
            for x in lm_inputs(cfg, OTHER_BATCH, OTHER_PROMPT, rng, n_img))
        run = greedy(model, tokens, positions, extra,
                     n_img + OTHER_PROMPT + OTHER_DECODE, OTHER_DECODE)
        if not torch.isfinite(run["decode_logits"]).all():
            fail(f"{name}: decode logits not finite")
        n_prompt = positions.shape[-1]
        check_cache_len(name, run["cache"], n_prompt + OTHER_DECODE)
        ext, pos_ext = extended(run, tokens, positions)
        want = model.forward(ext, pos_ext, extra)[0][
            :, n_prompt:n_prompt + OTHER_DECODE]
        gate = lm_gate(f"{name} decode vs forward ({OTHER_DECODE} steps)",
                       run["decode_logits"], want, LM_DECODE_BOUNDS,
                       LM_DECODE_ARGMAX)
        gate["layers"] = decode_per_layer(
            name, model, ext, pos_ext, extra, n_prompt,
            tuple(range(OTHER_DECODE)), n_prompt + OTHER_DECODE)
        torch.cuda.synchronize()
        out[name] = dict(gate, params=model.n_params(),
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        print(f"phase 12 (d) {name}: {cfg.n_layers} layer(s) at full width, "
              f"{out[name]['params']:,} parameters, peak "
              f"{out[name]['peak_gib']:.2f} GiB, prefill "
              f"{run['prefill_ms']:.2f} ms, decode steps "
              + ", ".join(f"{x:.2f}" for x in run["step_ms"])
              + f" ms; {time.perf_counter() - t0:.1f} s")
        del model, run
        gc.collect()
        torch.cuda.empty_cache()
    return out


def lm_path(device, card: str) -> tuple[dict, dict]:
    """Phase 12: the LM slice on the card; returns (results, the
    ``fused_cotm`` row at the head's shape)."""
    t0 = time.perf_counter()
    llama, row = llama_path(device, card)
    gc.collect()
    torch.cuda.empty_cache()
    others = other_configs(device)
    print(f"phase LM path: done in {time.perf_counter() - t0:.1f} s")
    return dict(llama=llama, others=others), row


# -- phase 13 --------------------------------------------------------------

# (a) rwkv6-7b and (b) zamba2-7b at full width and depth, one on the card
# at a time, through the port's Engine: generate LM_BATCH prompts of
# LM_PROMPT tokens for LM_DECODE greedy tokens (max_len LM_MAX_LEN), then
# serve_continuous len(SSM_MAX_NEW) requests of LM_PROMPT tokens at
# capacity LM_BATCH, each request's tokens held to generate's on its
# prompt (the last two prompts generated as a batch of LM_BATCH, so that
# every prefill and decode shape is the engine's).  zamba2 also generates
# SSM_WRAP_TOKENS tokens with max_len SSM_WRAP_MAX_LEN: its ring wraps.
# Decode against forward: each layer (zamba2: each mamba layer and each
# shared-block invocation) teacher-forced, and the first layers through
# prefill and LM_DECODE decode steps (rwkv6: LM_CPU_LAYERS; zamba2: the
# first hybrid_attn_every mamba layers and one shared block), which are
# also (c) held f32 on the card to f32 on the CPU.  (d) the TM head on the
# pooled prompt states.  Nothing is cut: both models run at full width
# and depth, with the phase 12 prompt shape.
SSM_ARCHS = ("rwkv6-7b", "zamba2-7b")
SSM_MAX_NEW = (12, 4, 8, 6, 10, 5)
# zamba2's head (K = 2 x 3584 = 7168) is a shape of its own and gets a
# row of the kernel table; rwkv6's (K = 8192) is phase 12's row's shape.
SSM_ROW_ARCH = "zamba2-7b"
SSM_WRAP_MAX_LEN, SSM_WRAP_TOKENS = 256, 8


def prefix_layers(cfg) -> int:
    """rwkv6: LM_CPU_LAYERS; zamba2: one full group and its shared
    block."""
    return cfg.hybrid_attn_every or LM_CPU_LAYERS


def ring_positions(n: int, W: int, like: torch.Tensor) -> torch.Tensor:
    """A ring of W slots after n tokens: positions max(0, n - W)..n-1 at
    their pos % W slots, every other slot empty."""
    from repro_torch.models.zamba2 import EMPTY_POS
    want = torch.full((W,), EMPTY_POS, dtype=like.dtype, device=like.device)
    keep = torch.arange(max(0, n - W), n, device=like.device)
    want[keep % W] = keep.to(like.dtype)
    return want.expand_as(like)


def check_ssm_cache(name: str, cache: dict, n: int) -> None:
    """Every float leaf finite; zamba2's rings hold len == n and the
    positions ``ring_positions`` says, exactly."""
    from repro_torch.models.base import leaves
    for path, v in leaves(cache):
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            fail(f"{name}: cache {path} not finite")
    if "attn" in cache:
        ring = cache["attn"]
        if not bool((ring["len"] == n).all()):
            fail(f"{name}: ring len {ring['len'].unique().tolist()}, "
                 f"want {n}")
        exact(f"{name} ring pos after {n} tokens", ring["pos"],
              ring_positions(n, ring["pos"].shape[-1], ring["pos"]))


def layer_runs(model, max_len: int) -> list:
    """The layers of ``model`` in the order its prefill runs them, each
    as ``fn(x, x0, positions, S, state) -> (x, state)``: ``state`` None
    is the prefill of a sequence of ``S`` (caches of ``max_len``), else
    one decode step against the layer's state (written in place where the
    model writes it); ``x0`` is the embedding (zamba2's shared block
    reads it)."""
    cfg = model.cfg
    if cfg.ssm is None:
        blocks = [(p, False) for p in (model.params["front"]
                                       if "front" in model.params else ())]
        blocks += [(p, cfg.moe is not None) for p in model.params["layers"]]

        def block(p, moe):
            def fn(x, x0, pos, S, st):
                x, _, c = model._block(p, x, pos, moe_layer=moe, cache=st,
                                       fill_len=max_len if st is None
                                       else None)
                if st is not None:
                    st["len"] = c["len"]
                    c = st
                return x, c
            return fn
        return [block(p, moe) for p, moe in blocks]
    if cfg.hybrid_attn_every == 0:
        def rwkv(p):
            def fn(x, x0, pos, S, st):
                x, new = model._block(p, x, st, S)
                if st is None:        # the prefill hands these on in bf16
                    new = dict(new, x_tm=new["x_tm"].to(torch.bfloat16),
                               x_cm=new["x_cm"].to(torch.bfloat16))
                return x, new
            return fn
        return [rwkv(p) for p in model.params["layers"]]
    from repro_torch.models.zamba2 import ATTN_WINDOW
    out = []
    for group, g in model.groups():
        out += [lambda x, x0, pos, S, st, i=i: model._mamba(i, x, S, st)
                for i in group]
        if g is not None:
            out.append(lambda x, x0, pos, S, st: model._shared_attn(
                x, x0, pos, cache=st, fill_window=(
                    min(ATTN_WINDOW, max_len) if st is None else None)))
    return out


def ssm_decode_per_layer(name: str, model, ext, pos_ext, n_prompt: int,
                         steps: tuple, max_len: int) -> dict:
    """Teacher-forced decode against forward, block by block: each block
    takes the forward's own input to it, prefills the first n_prompt + t
    positions into its state and decodes position n_prompt + t against
    it; held to the forward's output of that block (``layer_gate``)."""
    x0 = model.embed(ext)
    x = x0
    runs = layer_runs(model, max_len)
    decs, wants = [], []
    with torch.no_grad():
        for run in runs:
            out, _ = run(x, x0, pos_ext, x.shape[1], None)
            for t in steps:
                n = n_prompt + t
                _, st = run(x[:, :n], x0[:, :n], pos_ext[:, :n], n, None)
                dec, _ = run(x[:, n:n + 1], x0[:, n:n + 1],
                             pos_ext[:, n:n + 1], 1, st)
                decs.append(dec)
                wants.append(out[:, n:n + 1])
            x = out
    return layer_gate(name, decs, wants, f"decode vs forward, "
                      f"teacher-forced, {len(runs)} layers x steps {steps}")


def recording_engine(model, max_len: int):
    """The port's ``Engine`` keeping the logits of every sampled call on
    the host, for the tie check of ``check_continuous``."""
    from repro_torch.serve import Engine, ServeConfig

    class Recording(Engine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.seen = []

        def _sample(self, logits, generator):
            self.seen.append(logits.float().cpu())
            return super()._sample(logits, generator)

        def take(self) -> list:
            seen, self.seen = self.seen, []
            return seen

    return Recording(model, ServeConfig(max_len=max_len))


def continuous_rows(max_new: tuple, capacity: int) -> list[list]:
    """For each request, the (sampled call, row) of each of its tokens in
    ``serve_continuous``: a replay of its schedule (FIFO admission into
    the lowest free lanes, one prefill call an admission whose row i is
    its i-th newcomer, then one decode call a step over the lanes in
    order, a lane freed when its request has max_new tokens; no EOS)."""
    free, live = list(range(capacity)), {}
    out = [[] for _ in max_new]
    pending = list(range(len(max_new)))
    call = 0

    def done(lane: int) -> None:
        if len(out[live[lane]]) >= max_new[live[lane]]:
            del live[lane]
            free.append(lane)

    while pending or live:
        if pending and free:
            k = min(len(free), len(pending))
            lanes = []
            for i, r in enumerate(pending[:k]):
                lane = min(free)
                free.remove(lane)
                live[lane] = r
                out[r].append((call, i))
                lanes.append(lane)
            pending = pending[k:]
            for lane in lanes:
                done(lane)
            call += 1
        if live:
            for lane in sorted(live):
                out[live[lane]].append((call, lane))
            for lane in sorted(live):
                done(lane)
            call += 1
    return out


def check_continuous(name: str, served: dict, want: list, want_logits: list,
                     got_logits: list) -> dict:
    """Each request's tokens from ``serve_continuous`` equal generate's on
    its prompt (``want[r]``), token for token; where they differ, the
    first difference must be a tie that the row's own error explains
    (generate's top exceeds its logit at the served token by at most
    twice the max |served - generate| logit gap of that step), and the
    rest of that request is not compared (its stream took the other
    branch)."""
    rows = continuous_rows(SSM_MAX_NEW, LM_BATCH)
    n_exact, ties = 0, 0
    for r, m in enumerate(SSM_MAX_NEW):
        got = np.asarray(served[r]).ravel()
        if got.shape != (m,):
            fail(f"{name} request {r}: {got.shape[0]} tokens, want {m}")
        diff = np.flatnonzero(got != want[r][:m])
        if diff.size == 0:
            n_exact += 1
            continue
        t = int(diff[0])
        call, row = rows[r][t]
        g, c = want_logits[r][t].double(), got_logits[call][row].double()
        c = c.reshape(-1)
        g = g.reshape(-1)
        err = float((c - g).abs().max())
        gap = float(g.max() - g[int(got[t])])
        print(f"  {name} request {r}: differs from generate at token {t} "
              f"({int(got[t])} vs {int(want[r][t])}): generate's logit gap "
              f"{gap:.4e}, the step's max logit difference {err:.4e}")
        if not gap <= 2 * err:
            fail(f"{name} request {r}: token {t} differs from generate's "
                 f"and is not a tie")
        ties += 1
    print(f"  {name} serve_continuous: {n_exact} of {len(SSM_MAX_NEW)} "
          f"requests token for token equal to generate, {ties} at a tie")
    return dict(exact=n_exact, ties=ties)


def ring_wrap(name: str, model, prompts) -> None:
    """zamba2: generate with max_len SSM_WRAP_MAX_LEN (ring of 256 slots
    under a 512-token prompt) through the Engine, and the same prefill
    and decode steps by hand, the ring's len and positions exact after
    the prefill and after each step; the two token streams equal."""
    from repro_torch.serve import Engine, ServeConfig
    gen, _ = Engine(model, ServeConfig(max_len=SSM_WRAP_MAX_LEN)).generate(
        prompts, SSM_WRAP_TOKENS)
    B, S = prompts.shape
    pos = torch.arange(S, device=prompts.device).expand(B, S)
    logits, cache = model.prefill(prompts, pos, SSM_WRAP_MAX_LEN)
    check_ssm_cache(f"{name} wrap prefill", cache, S)
    toks = [logits.argmax(-1)]
    for t in range(SSM_WRAP_TOKENS - 1):
        logits, cache = model.decode_step(
            cache, toks[-1], torch.full((B, 1), S + t, device=pos.device))
        check_ssm_cache(f"{name} wrap step {t}", cache, S + t + 1)
        toks.append(logits.argmax(-1))
    exact(f"{name} wrapped generate vs prefill + decode steps", gen,
          torch.cat(toks, 1).to(gen.dtype))
    print(f"  {name} ring of {SSM_WRAP_MAX_LEN} slots under {S} tokens: "
          f"len and positions exact after the prefill and "
          f"{SSM_WRAP_TOKENS - 1} steps; generate's {SSM_WRAP_TOKENS} "
          f"tokens equal the hand loop's")


def lm_step_profile(name: str, model, tokens, positions, card: str) -> dict:
    """(e) One prefill and one decode step under ``torch.profiler``: the
    host wall, the device's busy share of it, the device kernels and the
    five that took the most device time."""
    from repro_torch.analysis.profile_window import device_profile
    logits, cache = model.prefill(tokens, positions, LM_MAX_LEN)
    tok, nxt = logits.argmax(-1), positions[:, -1:] + 1
    out = {}
    for label, fn in (
            ("prefill", lambda: model.prefill(tokens, positions, LM_MAX_LEN)),
            ("decode step", lambda: model.decode_step(cache, tok, nxt))):
        with device_profile() as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern, calls = pass_times(prof)
        busy = sum(kern.values()) * 1e-6
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:5]
        out[label] = dict(wall_ms=wall * 1e3, busy_ms=busy * 1e3,
                          kernels=sum(calls.values()))
        print(f"  {name} {label} under torch.profiler: wall {wall * 1e3:.2f} "
              f"ms, device busy {busy * 1e3:.2f} ms ({100 * busy / wall:.1f}% "
              f"of wall), {sum(calls.values())} device kernels; top: "
              + "; ".join(f"{n[:48]} x{calls[n]} {t / 1e3:.2f} ms"
                          for n, t in top) + f"; {card}")
    return out


def ssm_model_path(name: str, device, card: str, index: int) -> tuple:
    """(a) / (b) on one model at full width and depth; returns (results,
    the ``fused_cotm`` row at the head's shape)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import (TMHead, TMHeadConfig, build,
                                    pool_features)
    from repro_torch.serve import Request
    tag = "ab"[index]
    cfg = get_config(name)
    t0 = time.perf_counter()
    model = build(cfg, device=device).init(
        torch.Generator(device).manual_seed(SEED + 140 + index))
    torch.cuda.synchronize()
    print(f"phase 13 ({tag}) {name}: {model.n_params():,} parameters "
          f"({cfg.n_layers} layers, d {cfg.d_model}, d_ff {cfg.d_ff}, V "
          f"{cfg.vocab}), {cfg.param_dtype} weights, {cfg.dtype} compute, "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; "
          f"cut: none (full width and depth)")
    rng = np.random.default_rng(SEED + 142 + index)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (len(SSM_MAX_NEW), LM_PROMPT))).to(device)
    main = prompts[:LM_BATCH]
    extra = list(range(LM_BATCH, len(SSM_MAX_NEW)))
    rest = prompts[(extra * LM_BATCH)[:LM_BATCH]]
    positions = torch.arange(LM_PROMPT, device=device).expand(
        LM_BATCH, LM_PROMPT)
    head = TMHead(TMHeadConfig(), d_features=cfg.d_model)
    hparams = tm_head_params(head.cotm_cfg.n_literals, head.cfg.n_clauses,
                             head.cfg.n_classes, head.cfg.n_states,
                             SEED + 144 + index, device)
    engine = recording_engine(model, LM_MAX_LEN)

    # The main path, in one launch-count window: the Engine's generate on
    # the 4 prompts and on the last two, serve_continuous of all six, the
    # head's scores on the pooled prompt states through fused_cotm.
    peaks = {}

    def stage(label: str) -> None:
        """The peak memory since the last stage."""
        torch.cuda.synchronize()
        peaks[label] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    gen_main, _ = engine.generate(main, LM_DECODE)
    logits_main = engine.take()
    stage("generate")
    gen_rest, _ = engine.generate(rest, LM_DECODE)
    logits_rest = engine.take()
    reqs = [Request(i, prompts[i].cpu().numpy(), max_new=m)
            for i, m in enumerate(SSM_MAX_NEW)]
    served, sstats = engine.serve_continuous(reqs, capacity=LM_BATCH)
    logits_served = engine.take()
    stage("serve_continuous")
    hidden, _ = model.hidden(main)
    feats = pool_features(hidden)
    scores, err = head_scores(f"{name} TM head scores", head, hparams, feats)
    stage("hidden + head")
    launches = kernels.launch_counts()
    peak = max(peaks.values())
    if launches["fused_cotm_i32"] == 0:
        fail(f"fused_cotm was never launched on the {name} path")
    print(f"phase 13 ({tag}) main path: launches "
          f"{ {k: v for k, v in launches.items() if v} }; peak memory "
          f"{peak:.2f} GiB (torch.cuda.max_memory_allocated; by stage: "
          + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items()) + ")")

    # generate's tokens (and logits, a row per request) against
    # serve_continuous, request for request
    want, want_logits = [], []
    for r in range(len(SSM_MAX_NEW)):
        g, logs, row = ((gen_main, logits_main, r) if r < LM_BATCH
                        else (gen_rest, logits_rest, r - LM_BATCH))
        want.append(g[row].cpu().numpy())
        want_logits.append([x[row] for x in logs])
    cont = check_continuous(name, served, want, want_logits, logits_served)

    # The same prefill and decode steps by hand, between CUDA events: the
    # engine's tokens, every recurrent state finite, zamba2's rings exact.
    run = greedy(model, main, positions, None, LM_MAX_LEN, LM_DECODE)
    exact(f"{name} Engine.generate vs prefill + decode steps", gen_main,
          run["fed"].to(gen_main.dtype))
    check_ssm_cache(name, run["cache"], LM_PROMPT + LM_DECODE)
    if not torch.isfinite(run["decode_logits"]).all():
        fail(f"{name}: decode logits not finite")
    ext, pos_ext = extended(run, main, positions)
    dec = ssm_decode_per_layer(name, model, ext, pos_ext, LM_PROMPT,
                               (0, LM_DECODE - 1), LM_MAX_LEN)
    fwd = model.forward(ext, pos_ext)[0][:, LM_PROMPT:LM_PROMPT + LM_DECODE]
    dec["end_to_end"] = dict(rel_stats(run["decode_logits"], fwd), argmax=(
        float((run["decode_logits"].argmax(-1) == fwd.argmax(-1))
              .double().mean())))
    del fwd
    print(f"  {name} {cfg.n_layers} layers, decode vs forward (a note, not "
          f"gated): rel err median {dec['end_to_end']['median']:.3e} p99 "
          f"{dec['end_to_end']['p99']:.3e} max "
          f"{dec['end_to_end']['max']:.3e}; argmax equal at "
          f"{dec['end_to_end']['argmax']:.4f} of {LM_BATCH * LM_DECODE} "
          f"positions")
    n_prefix = prefix_layers(cfg)
    dec["prefix"] = prefix_decode(model, main, positions, n_prefix,
                                  check=check_ssm_cache)
    if cfg.hybrid_attn_every:
        ring_wrap(name, model, main)

    # (d) the head: scores bitwise (checked above), the kernel row at
    # K = 2 x d (zamba2: 7168, a shape of its own)
    print(f"phase 13 (d) TM head on pooled {name} prompt states: K = "
          f"{head.cotm_cfg.n_literals} literals, {head.cfg.n_clauses} "
          f"clauses, {head.cfg.n_classes} classes; scores bitwise equal to "
          f"fused_cotm_ref on the card ({int((scores != 0).sum())} nonzero "
          f"of {scores.numel()}); fused_cotm launches on the path "
          f"{launches['fused_cotm_i32']}")
    row = None
    if name == SSM_ROW_ARCH:
        row = head_kernel_row(
            head, hparams, feats, launches["fused_cotm_i32"], err,
            name=f"fused_cotm (TM head, K = {head.cotm_cfg.n_literals})")
        print(f"{row['name']}: {row['ms']:.4f} ms (plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} "
              f"ms, bound {row['bound_ms']:.5f} ms by {row['bound_by']}), "
              f"{row['launches']} launches on the path; {card}")

    # (e) times: prefill again, each decode step of the timed run, the
    # continuous engine's requests/s and latency (host clock)
    pre = [run["prefill_ms"]]
    for _ in range(LM_TIMED_PREFILLS):
        pre.append(greedy(model, main, positions, None, LM_MAX_LEN,
                          0)["prefill_ms"])
    p_ms, d_ms = statistics.median(pre), statistics.median(run["step_ms"])
    lat = sstats["latency"]
    times = dict(prefill_ms=p_ms, prefill_tokens_s=LM_BATCH * LM_PROMPT
                 / (p_ms / 1e3), decode_step_ms=d_ms,
                 decode_tokens_s=LM_BATCH / (d_ms / 1e3),
                 requests_s=len(SSM_MAX_NEW) / sstats["wall_s"],
                 latency_p50_s=lat["p50_s"], latency_p99_s=lat["p99_s"],
                 peak_gib=peak, decode=dec, continuous=cont,
                 profile=lm_step_profile(name, model, main, positions, card))
    print(f"phase 13 (e) {name} B={LM_BATCH}: prefill of {LM_PROMPT} tokens "
          f"{p_ms:.2f} ms ({times['prefill_tokens_s']:.1f} tokens/s; median "
          f"of {len(pre)}: " + ", ".join(f"{x:.2f}" for x in pre)
          + f"), decode step {d_ms:.3f} ms ({times['decode_tokens_s']:.1f} "
          f"tokens/s; median of {LM_DECODE}: "
          + ", ".join(f"{x:.2f}" for x in run["step_ms"])
          + f"); CUDA events.  serve_continuous of {len(SSM_MAX_NEW)} "
          f"requests at capacity {LM_BATCH}: {sstats['decode_steps']} "
          f"decode steps, {times['requests_s']:.3f} requests/s, latency "
          f"p50 {lat['p50_s']:.3f} s p99 {lat['p99_s']:.3f} s (host "
          f"clock); peak {times['peak_gib']:.2f} GiB; {card}")
    del run, engine, hidden
    times["cpu"] = cpu_parity(model, device, n_prefix)
    return times, row


def ssm_path(device, card: str) -> tuple[dict, dict]:
    """Phase 13: the ssm and hybrid families on the card; returns
    (results, the ``fused_cotm`` row at zamba2's head shape)."""
    t0 = time.perf_counter()
    out, row = {}, None
    for i, name in enumerate(SSM_ARCHS):
        out[name], r = ssm_model_path(name, device, card, i)
        row = r or row
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase SSM path: done in {time.perf_counter() - t0:.1f} s")
    return out, row


# -- phase 14 --------------------------------------------------------------

# (a) llama3-8b at full width, TRAIN_LAYERS deep (the 32-layer training
# state, f32 master + m + v + gradient of 8.03e9 parameters, is 128.5 GB:
# more than the card), bf16 compute, remat on (the config's own), f32
# moments (its opt_moment_dtype): TRAIN_STEPS steps of TRAIN_ACCUM
# microbatches of TRAIN_BATCH x TRAIN_SEQ synth_tokens, the same batch
# every step.  (b) its first TRAIN_CPU_LAYERS layers, f32 compute, one
# step at TRAIN_CPU_BATCH x TRAIN_CPU_SEQ on the card and on the CPU.  (c)
# the other configs at full width one layer deep (deepseek: its dense
# front layer and one MoE layer; zamba2: hybrid_attn_every mamba layers
# and the shared block), grok-1 as train_lm's ~100M variant (one layer is
# 97.3 GiB of state), TRAIN_OTHER_STEPS steps of TRAIN_OTHER_BATCH x
# TRAIN_OTHER_SEQ.  (d) repro_torch.train_lm at the reference example's
# size (llama3-8b's variant, batch 8, seq 256): TRAIN_LM_STEPS steps
# uninterrupted, then failing at TRAIN_LM_FAIL and resumed.  (e) the int8
# all-reduce in a gloo world of INT8_WORLD ranks on the card against the
# same calls on CPU tensors.  (f) (a)'s times, FLOPs and memory.
TRAIN_ARCH, TRAIN_LAYERS = "llama3-8b", 8
TRAIN_ACCUM, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4, 512, 6
TRAIN_LR = 1e-3
# (b) runs one layer: its full-width CPU legs are most of the phase's
# time
TRAIN_CPU_LAYERS, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, TRAIN_CPU_LR = 1, 2, 64, 1e-4
TRAIN_OTHER_BATCH, TRAIN_OTHER_SEQ, TRAIN_OTHER_STEPS = 2, 128, 2
TRAIN_LM_STEPS, TRAIN_LM_FAIL, TRAIN_LM_SAVE = 60, 30, 15
TRAIN_LM_BATCH, TRAIN_LM_SEQ = 8, 256       # examples/train_lm.py's defaults
INT8_WORLD, INT8_STEPS = 4, 3
# (b) holds the card to the CPU with the CPU tests' f32 bounds
# (tests/test_torch_train_step.py): loss rtol 1e-5, each leaf's gradient
# within 1e-2 in relative Frobenius norm.  At the reference's init the
# f32 step is not that well conditioned at full width: q and k come out
# with std ~11 and ~23, the attention logits with std ~255, and a
# one-ulp nudge of the f32 parameters moves the card's own gradients by
# 6.4% and its loss by 1.9e-5 (measured on one H100; 4.3% at d = 512 and
# 1024 on the CPU).  So the gated comparison scales wq and wk by
# TRAIN_CPU_SOFTEN (logit std ~1), where that floor is ~3e-3 and a
# device difference stands out; the reference's own scale is compared
# and printed beside its floor, not gated.  After one train_step, Adam's
# first update moves each element by lr x the sign of its gradient (plus
# the decay), so an element whose gradient sits at the noise level may
# move the other way on the card: no element of the parameters may
# differ by more than 2 x lr (+ 1e-6 of the element), and each leaf's
# update keeps a cosine of 0.99 with the CPU's.
TRAIN_CPU_LOSS_RTOL, TRAIN_CPU_GRAD_FROB = 1e-5, 1e-2
TRAIN_CPU_UPDATE_COS, TRAIN_CPU_SOFTEN = 0.99, 1 / 16
# A sample of each leaf (every TRAIN_SAMPLE_STRIDE-th element) tells
# whether the step changed it, without a second copy of the state.
TRAIN_SAMPLE_STRIDE = 997


def leaf_samples(tree) -> dict:
    from repro_torch.models.base import leaves
    return {p: t.detach().reshape(-1)[::TRAIN_SAMPLE_STRIDE].clone()
            for p, t in leaves(tree)}


def rel_frob(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


@contextlib.contextmanager
def step_events():
    """CUDA events around each microbatch's forward + backward
    (``step.backward_into``) and around the optimizer (``apply_updates``)
    inside ``train_step``: the step module's own functions, wrapped for
    the window."""
    from repro_torch.train import step as step_mod
    marks = {"micro": [], "opt": []}
    orig_bwd, orig_opt = step_mod.backward_into, step_mod.apply_updates

    def timed(kind, fn):
        def run(*args, **kwargs):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args, **kwargs)
            e.record()
            marks[kind].append((s, e))
            return out
        return run
    step_mod.backward_into = timed("micro", orig_bwd)
    step_mod.apply_updates = timed("opt", orig_opt)
    try:
        yield marks
    finally:
        step_mod.backward_into, step_mod.apply_updates = orig_bwd, orig_opt


def train_step_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step with every layer rematerialized:
    the GEMMs (2 a multiply-add of each weight a token) forward, twice that
    backward, the layers' forward again; attention's QK^T and PV over the
    causal chunk grid as computed (S x S a sequence, each 2 x S x S x H x
    hd), four times (forward, recompute, two backward products).  The
    embedding is a gather, not a GEMM."""
    d, L = cfg.d_model, cfg.n_layers
    hd, H, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    layer = d * hd * (2 * H + 2 * Hkv) + 3 * d * cfg.d_ff
    head = d * cfg.vocab
    gemm = 2 * tokens * (3 * (L * layer + head) + L * layer)
    attn = (tokens // seq) * L * 2 * (2 * seq * seq * H * hd) * 4
    return float(gemm + attn)


def train_batch(cfg, accum: int, batch: int, seq: int, seed: int) -> dict:
    """``synth_tokens`` as a train step's batch (``train_lm.lm_batch``):
    (accum, batch, seq[, C]), with text-only M-RoPE positions for
    qwen2-vl."""
    from repro_torch.launch.specs import synth_tokens
    from repro_torch.train_lm import lm_batch
    return lm_batch(cfg, synth_tokens(cfg, accum * batch, seq, seed=seed),
                    accum)


def train_llama(device, card: str) -> dict:
    """(a) and (f): llama3-8b at full width, TRAIN_LAYERS deep."""
    from repro_torch.analysis.profile_window import device_profile
    from repro_torch.configs import get_config
    from repro_torch.models import build, torch_dtype
    from repro_torch.models.base import leaves
    from repro_torch.sharding.layout import record_traffic
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    # Drawn on the card through a model whose own copy is dropped at once;
    # the step runs a model on "meta" over the state's tree.
    params = build(cfg, device=device).init(
        torch.Generator(device).manual_seed(SEED + 140)).tree()
    gc.collect()
    torch.cuda.empty_cache()
    model = build(cfg, device="meta")
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                      moment_dtype=torch_dtype(cfg.opt_moment_dtype))
    state = init_state(params, opt)
    del params
    n = model.n_params()
    state_gib = 4 * 4 * n / 2**30          # master, m, v, gradient in f32
    torch.cuda.synchronize()
    print(f"phase 14 (a) {TRAIN_ARCH} x {TRAIN_LAYERS} layers at full width "
          f"(d {cfg.d_model}, d_ff {cfg.d_ff}, V {cfg.vocab}): {n:,} f32 "
          f"master parameters drawn on the card, {cfg.dtype} compute, remat "
          f"{cfg.remat}, {opt.moment_dtype} moments; master + m + v + "
          f"gradient {state_gib:.2f} GiB; "
          f"{(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB "
          f"allocated after init ({time.perf_counter() - t0:.1f} s)")
    step = make_train_step(model, opt, device=device)
    batch = train_batch(cfg, TRAIN_ACCUM, TRAIN_BATCH, TRAIN_SEQ, SEED + 141)
    before = leaf_samples(state.params)
    losses, norms, step_ms, micro_ms, opt_ms, sent = [], [], [], [], [], []
    # the steps' own peak (phase 17), after the draw's
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        with step_events() as marks, record_traffic() as moved:
            s.record()
            state, metrics = step(state, batch, i)
            e.record()
        torch.cuda.synchronize()
        sent.append(moved.bytes)
        step_ms.append(s.elapsed_time(e))
        micro_ms.append([a.elapsed_time(b) for a, b in marks["micro"]])
        opt_ms.append(marks["opt"][0][0].elapsed_time(marks["opt"][0][1]))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if not (np.isfinite(losses[-1]) and np.isfinite(norms[-1])):
            fail(f"phase 14 (a) step {i}: loss {losses[-1]} grad_norm "
                 f"{norms[-1]}")
    steps_peak = torch.cuda.max_memory_allocated()
    peak = max(init_peak, steps_peak) - base
    if not losses[-1] < losses[0]:
        fail(f"phase 14 (a): loss did not fall: {losses}")
    after = leaf_samples(state.params)
    still = [p for p in before if torch.equal(before[p], after[p])]
    if still:
        fail(f"phase 14 (a): leaves not updated: {still}")
    print(f"  losses " + ", ".join(f"{x:.4f}" for x in losses)
          + "; grad norms " + ", ".join(f"{x:.3f}" for x in norms)
          + f"; all {len(before)} leaves updated")

    # One more step under torch.profiler: the device's busy share.
    with device_profile() as prof:
        t1 = time.perf_counter()
        state, _ = step(state, batch, TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    kern, calls = pass_times(prof)
    busy = sum(kern.values()) * 1e-6
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
    tokens = TRAIN_ACCUM * TRAIN_BATCH * TRAIN_SEQ
    med = statistics.median(step_ms[1:])
    flops = train_step_flops(cfg, tokens, TRAIN_SEQ)
    out = dict(losses=losses, grad_norms=norms, step_ms=step_ms,
               micro_ms=micro_ms, opt_ms=opt_ms, step_ms_median=med,
               tokens_s=tokens / (med / 1e3), flops=flops,
               flop_share=flops / (med / 1e3) / 989e12,
               peak_gib=peak / 2**30, state_gib=state_gib,
               busy_share=busy / wall, wall_ms=wall * 1e3,
               kernels=sum(calls.values()), steps_peak=steps_peak,
               state_bytes=state_bytes(state), sent=sent)
    print(f"phase 14 (f) {TRAIN_ARCH} x {TRAIN_LAYERS}, {TRAIN_ACCUM} x "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step: step "
          f"{med:.1f} ms (median of steps 2-{TRAIN_STEPS}; all "
          + ", ".join(f"{x:.1f}" for x in step_ms)
          + "), forward + backward a microbatch "
          + "; ".join("/".join(f"{x:.1f}" for x in m) for m in micro_ms)
          + " ms, optimizer " + ", ".join(f"{x:.1f}" for x in opt_ms)
          + f" ms (CUDA events); {out['tokens_s']:.1f} tokens/s; "
          f"{flops:.3e} model FLOPs a step (remat), "
          f"{100 * out['flop_share']:.1f}% of the 989 TFLOP/s bf16 dense "
          f"peak; peak memory {out['peak_gib']:.2f} GiB above the "
          f"phase's start (state {state_gib:.2f} GiB; "
          f"torch.cuda.max_memory_allocated); {card}")
    print(f"  one step under torch.profiler: wall {wall * 1e3:.1f} ms, "
          f"device busy {busy * 1e3:.1f} ms ({100 * out['busy_share']:.1f}% "
          f"of wall), {out['kernels']} device kernels; largest: "
          + "; ".join(f"{n_[:60]} x{calls[n_]} {t / 1e3:.2f} ms"
                      for n_, t in top) + f"; {card}")
    del state, step, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def cpu_gaps(model, host, batch, device, lr: float | None) -> dict:
    """The loss and each leaf's gradient (``backward_into``) of ``host``
    (the reference's tree on the CPU) on the card, on the CPU and on the
    card one ulp away (random signs); with ``lr``, one ``train_step`` on
    the card and on the CPU.  -> the gaps: loss (relative), the worst
    leaf's gradient (relative Frobenius), the same two for the nudged
    card against the card, and the step's largest parameter gap (in
    units of 2 lr) and least update cosine."""
    from repro_torch.models.base import leaves, tree_map
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    from repro_torch.train.step import backward_into
    gen = torch.Generator().manual_seed(SEED + 144)
    nudge = lambda t: t * (1 + (torch.randint(0, 2, t.shape, generator=gen)
                                * 2 - 1) * 2.0 ** -23)
    mb = {k: torch.from_numpy(v[0]) for k, v in batch.items()}
    out = {}
    for where, dev, tweak in (("card", device, None),
                              ("cpu", torch.device("cpu"), None),
                              ("nudged", device, nudge)):
        init = host if tweak is None else tree_map(tweak, host)
        masters = tree_map(lambda t: t.to(dev, copy=True).requires_grad_(),
                           init)
        loss = backward_into(model, masters,
                             {k: v.to(dev) for k, v in mb.items()})
        out[where] = dict(loss=float(loss), grads={
            p: m.grad.cpu() for p, m in leaves(masters)})
        del masters
        if tweak is None and lr is not None:
            opt = AdamWConfig(lr=lr, warmup_steps=1)
            state = init_state(tree_map(lambda t: t.to(dev, copy=True),
                                        host), opt)
            state, _ = make_train_step(model, opt, device=dev)(
                state, batch, 0)
            out[where]["params"] = {p: t.cpu() for p, t in
                                    leaves(state.params)}
            del state
        gc.collect()
        torch.cuda.empty_cache()

    def gaps(a, b):
        return (abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                max((rel_frob(a["grads"][p], g), p)
                    for p, g in b["grads"].items()))
    card, cpu = out["card"], out["cpu"]
    res = dict(loss=card["loss"], cpu_loss=cpu["loss"])
    res["loss_rel"], res["grad"] = gaps(card, cpu)
    res["floor_loss"], res["floor_grad"] = gaps(out["nudged"], card)
    if lr is not None:
        init = dict(leaves(host))
        res["param_gap"] = max(
            (float(((card["params"][p] - w).abs()
                    / (2 * lr + 1e-6 * w.abs())).max()), p)
            for p, w in cpu["params"].items())
        res["cos"] = min((float(torch.nn.functional.cosine_similarity(
            (card["params"][p] - init[p]).double().reshape(1, -1),
            (w - init[p]).double().reshape(1, -1))), p)
            for p, w in cpu["params"].items())
    return res


def state_bytes(state) -> int:
    """The bytes of a train state's parameters and moments on this
    rank."""
    from repro_torch.models.base import leaves
    return sum(t.numel() * t.element_size() for part in (
        state.params, state.m, state.v) for _, t in leaves(part))


def train_cpu_parity(device) -> dict:
    """(b) llama3-8b's first TRAIN_CPU_LAYERS layers at full width in f32
    compute on the card against the CPU: gated with wq and wk scaled by
    TRAIN_CPU_SOFTEN, printed at the reference's own scale (see the
    bounds' comment)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TRAIN_CPU_LAYERS, dtype="float32")
    host = build(cfg, device="cpu").init(
        torch.Generator().manual_seed(SEED + 142)).tree()
    batch = train_batch(cfg, 1, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, SEED + 143)
    model = build(cfg, device="meta")
    own = cpu_gaps(model, host, batch, device, None)
    attn = host["layers"]["attn"]
    for w in ("wq", "wk"):
        attn[w] = attn[w] * TRAIN_CPU_SOFTEN
    res = cpu_gaps(model, host, batch, device, TRAIN_CPU_LR)
    label = (f"phase 14 (b) {TRAIN_ARCH} x {TRAIN_CPU_LAYERS} layers f32, "
             f"card vs CPU, B = {TRAIN_CPU_BATCH}, S = {TRAIN_CPU_SEQ}")
    print(f"{label}, at the reference's init (printed, not gated): loss "
          f"{own['loss']:.7f} / {own['cpu_loss']:.7f} (rel "
          f"{own['loss_rel']:.2e}), worst gradient {own['grad'][0]:.2e} "
          f"{own['grad'][1]}; the card one ulp from itself: loss "
          f"{own['floor_loss']:.2e}, gradient {own['floor_grad'][0]:.2e} "
          f"{own['floor_grad'][1]}")
    print(f"{label}, wq and wk x {TRAIN_CPU_SOFTEN}: loss "
          f"{res['loss']:.7f} / {res['cpu_loss']:.7f} (rel "
          f"{res['loss_rel']:.2e}, bound {TRAIN_CPU_LOSS_RTOL}); worst "
          f"gradient {res['grad'][0]:.2e} {res['grad'][1]} (bound "
          f"{TRAIN_CPU_GRAD_FROB}); the card one ulp from itself: loss "
          f"{res['floor_loss']:.2e}, gradient {res['floor_grad'][0]:.2e}; "
          f"after one train_step (lr {TRAIN_CPU_LR}) the largest parameter "
          f"gap is {res['param_gap'][0]:.3e} of 2 lr {res['param_gap'][1]} "
          f"(bound 1), least update cosine {res['cos'][0]:.6f} "
          f"{res['cos'][1]} (bound {TRAIN_CPU_UPDATE_COS})")
    if not res["loss_rel"] <= TRAIN_CPU_LOSS_RTOL:
        fail(f"phase 14 (b): loss {res['loss']} CPU {res['cpu_loss']}")
    if not res["grad"][0] <= TRAIN_CPU_GRAD_FROB:
        fail(f"phase 14 (b): gradient {res['grad']}")
    if not res["param_gap"][0] <= 1.0:
        fail(f"phase 14 (b): parameters {res['param_gap']}")
    if not res["cos"][0] >= TRAIN_CPU_UPDATE_COS:
        fail(f"phase 14 (b): update cosine {res['cos']}")
    return dict(reference_init=own, softened=res)


def train_others(device) -> dict:
    """(c) every other config at full width, one layer deep (grok-1 as
    train_lm's variant): TRAIN_OTHER_STEPS steps, then one
    ``backward_into`` whose every gradient is finite and nonzero."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import build, torch_dtype
    from repro_torch.models.base import leaves, tree_map
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    from repro_torch.train.step import backward_into
    from repro_torch.train_lm import hundred_m_variant
    out = {}
    for i, name in enumerate(ARCH_IDS):
        if name == TRAIN_ARCH:
            continue
        cfg = get_config(name)
        if name.startswith("grok"):
            cfg, cut = hundred_m_variant(cfg), "train_lm's ~100M variant"
        elif cfg.hybrid_attn_every:
            cfg = dataclasses.replace(cfg, n_layers=cfg.hybrid_attn_every)
            cut = f"{cfg.n_layers} mamba layers and the shared block"
        else:
            front = cfg.moe.first_dense_layers if cfg.moe else 0
            cfg = dataclasses.replace(cfg, n_layers=front + 1)
            cut = f"{cfg.n_layers} layer(s)"
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        params = build(cfg, device=device).init(
            torch.Generator(device).manual_seed(SEED + 150 + i)).tree()
        gc.collect()
        torch.cuda.empty_cache()
        model = build(cfg, device="meta")
        opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                          moment_dtype=torch_dtype(cfg.opt_moment_dtype))
        state = init_state(params, opt)
        step = make_train_step(model, opt, device=device)
        batch = train_batch(cfg, 1, TRAIN_OTHER_BATCH, TRAIN_OTHER_SEQ,
                            SEED + 160 + i)
        losses = []
        for s in range(TRAIN_OTHER_STEPS):
            state, metrics = step(state, batch, s)
            losses.append(float(metrics["loss"]))
            if not (np.isfinite(losses[-1])
                    and np.isfinite(float(metrics["grad_norm"]))):
                fail(f"phase 14 (c) {name}: step {s} {metrics}")
        masters = tree_map(lambda t: t.detach().requires_grad_(),
                           state.params)
        backward_into(model, masters, {k: torch.as_tensor(v[0]).to(device)
                                       for k, v in batch.items()})
        bad = [p for p, m in leaves(masters)
               if m.grad is None or not bool(torch.isfinite(m.grad).all())
               or not bool((m.grad != 0).any())]
        if bad:
            fail(f"phase 14 (c) {name}: gradients zero or not finite: {bad}")
        torch.cuda.synchronize()
        out[name] = dict(params=model.n_params(), losses=losses,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        print(f"phase 14 (c) {name} ({cut}, full width"
              + (" of the variant" if name.startswith("grok") else "")
              + f"): {out[name]['params']:,} parameters, losses "
              + ", ".join(f"{x:.4f}" for x in losses)
              + f", {len(list(leaves(masters)))} leaves with finite nonzero "
              f"gradients, peak {out[name]['peak_gib']:.2f} GiB; "
              f"{time.perf_counter() - t0:.1f} s")
        del params, state, step, masters, model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_driver(device) -> dict:
    """(d) ``repro_torch.train_lm`` at the reference example's size:
    TRAIN_LM_STEPS steps uninterrupted; then a run that fails at
    TRAIN_LM_FAIL and one that resumes it (checkpoints every
    TRAIN_LM_SAVE steps).  The resumed losses must be the uninterrupted
    run's bit for bit; the failed run's first losses show that the card
    repeats a step bit for bit (the resume's premise)."""
    import tempfile
    from repro_torch import train_lm
    from repro_torch.train import (CheckpointManager, RuntimeConfig,
                                   SimulatedFailure)
    t0 = time.perf_counter()
    kw = dict(steps=TRAIN_LM_STEPS, batch=TRAIN_LM_BATCH, seq=TRAIN_LM_SEQ,
              lr=3e-4,
              save_every=TRAIN_LM_SAVE, device=device, log=lambda *a: None)
    with tempfile.TemporaryDirectory() as tmp:
        ref = train_lm.train(TRAIN_ARCH, ckpt_dir=f"{tmp}/ref", **kw)
        try:
            train_lm.train(TRAIN_ARCH, ckpt_dir=f"{tmp}/ft",
                           fail_at_step=TRAIN_LM_FAIL, **kw)
            fail("phase 14 (d): the injected failure did not raise")
        except SimulatedFailure:
            pass
        first = CheckpointManager(f"{tmp}/ft").latest_step()
        resumed = train_lm.train(TRAIN_ARCH, ckpt_dir=f"{tmp}/ft", **kw)
        hb = json.loads(open(f"{tmp}/ft/HEARTBEAT").read())
    losses = ref["losses"]
    k = max(len(losses) // 10, 1)
    print(f"phase 14 (d) train_lm {TRAIN_ARCH} variant "
          f"({ref['model'].n_params() / 1e6:.1f}M parameters), batch "
          f"{TRAIN_LM_BATCH}, seq {TRAIN_LM_SEQ}, {TRAIN_LM_STEPS} steps: "
          f"loss first{k} "
          f"{np.mean(losses[:k]):.4f} last{k} {np.mean(losses[-k:]):.4f}; "
          f"failed at {TRAIN_LM_FAIL} with step {first} published, resumed "
          f"from {resumed['start']}: {len(resumed['losses'])} losses "
          f"{'equal' if resumed['losses'] == losses[first:] else 'UNEQUAL'} "
          f"to the uninterrupted run's, bit for bit; heartbeat step "
          f"{hb['step']}; median step {statistics.median(ref['loop'].step_times) * 1e3:.1f} "
          f"ms (host clock); {time.perf_counter() - t0:.1f} s")
    if not np.mean(losses[-k:]) < np.mean(losses[:k]):
        fail("phase 14 (d): loss did not decrease")
    if first != TRAIN_LM_FAIL or resumed["start"] != TRAIN_LM_FAIL:
        fail(f"phase 14 (d): resumed from {resumed['start']}, published "
             f"{first}")
    if resumed["losses"] != losses[TRAIN_LM_FAIL:]:
        fail(f"phase 14 (d): resumed losses {resumed['losses'][:3]} ... "
             f"differ from {losses[TRAIN_LM_FAIL:TRAIN_LM_FAIL + 3]} ...")
    every = RuntimeConfig(ckpt_dir="").heartbeat_every
    if hb["step"] != TRAIN_LM_STEPS // every * every:
        fail(f"phase 14 (d): heartbeat {hb}")
    return dict(losses=losses, resumed=resumed["losses"],
                step_s=statistics.median(ref["loop"].step_times))


def int8_rank(rank: int, out_dir: str, device: str = "cuda") -> None:
    """(e) on one rank of the gloo world: ``int8_psum`` and
    ``compressed_grad_allreduce`` over INT8_STEPS steps on the card and on
    CPU tensors, bit for bit."""
    from repro_torch.train import compressed_grad_allreduce, int8_psum
    rng = np.random.default_rng(SEED + 170 + rank)
    x = rng.standard_normal((1024, 1025)).astype(np.float32)
    grads = [{"a": rng.standard_normal((4096, 1024)).astype(np.float32)
              * 1e-2, "b": rng.standard_normal(4097).astype(np.float32)}
             for _ in range(INT8_STEPS)]
    res = {}
    for dev in (device, "cpu"):
        got = [int8_psum(torch.from_numpy(x).to(dev)).cpu()]
        err = {k: torch.zeros(v.shape, device=dev) for k, v in
               grads[0].items()}
        for g in grads:
            tot, err = compressed_grad_allreduce(
                {k: torch.from_numpy(v).to(dev) for k, v in g.items()}, err)
            got += [tot["a"].cpu(), tot["b"].cpu(), err["a"].cpu(),
                    err["b"].cpu()]
        res[dev] = got
    equal = all(torch.equal(a, b) for a, b in zip(res[device], res["cpu"]))
    with open(os.path.join(out_dir, f"int8_rank{rank}.json"), "w") as f:
        json.dump(dict(rank=rank, equal=equal, tensors=len(res["cpu"]),
                       psum_sum=float(res["cpu"][0].double().sum()),
                       elements=sum(t.numel() for t in res["cpu"])), f)


def int8_path(device: str = "cuda") -> dict:
    """(e) one spawn of INT8_WORLD processes on the card."""
    import tempfile
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spawn(int8_rank, INT8_WORLD, tmp, device,
              init_method=f"file://{tmp}/store")
        ranks = [json.load(open(os.path.join(tmp, f"int8_rank{r}.json")))
                 for r in range(INT8_WORLD)]
    sums = {r["psum_sum"] for r in ranks}
    print(f"phase 14 (e) int8_psum and compressed_grad_allreduce "
          f"({INT8_STEPS} steps of error feedback) in a gloo world of "
          f"{INT8_WORLD} on the card: "
          + ", ".join(f"rank {r['rank']} {r['tensors']} tensors "
                      f"({r['elements']:,} elements) "
                      f"{'bitwise equal' if r['equal'] else 'DIFFERENT'} "
                      f"to CPU tensors" for r in ranks)
          + f"; every rank's sum the same: {len(sums) == 1}; "
          f"{time.perf_counter() - t0:.1f} s")
    if not all(r["equal"] for r in ranks) or len(sums) != 1:
        fail("phase 14 (e): the int8 all-reduce differs on the card")
    return dict(ranks=ranks)


def train_lm_path(device, card: str) -> dict:
    """Phase 14: LM training on the card."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(llama=train_llama(device, card))
    out["cpu"] = train_cpu_parity(device)
    out["others"] = train_others(device)
    out["driver"] = train_driver(device)
    out["int8"] = int8_path(device.type)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase LM training path: done in {out['seconds']:.1f} s; {card}")
    return out


# -- phase 15 --------------------------------------------------------------

# (a) llama3-8b at full width, ZERO_LAYERS deep, in its own posture, on a
# ZERO_MESH mesh of a gloo world on the one card: ZERO_STEPS steps of
# ZERO_ACCUM microbatches of ZERO_BATCH x ZERO_SEQ (ZERO_BATCH / 2 rows a
# data rank).  (b) one layer in f32 with phase 14 (b)'s batch, scale and
# lr, ZeRO-3 (at zero3=False the f32 gathered tree and gradients of two
# layers come to ~20 GB a rank, more than the card holds for four), one
# step on one device and in the world; bounds: phase 14 (b)'s loss and
# gradient, and ZERO_UPDATE_FROB for each leaf's update.
ZERO_WORLD, ZERO_MESH = 4, (2, 2)
ZERO_LAYERS, ZERO_ACCUM, ZERO_BATCH, ZERO_SEQ = 2, 2, 4, 512
ZERO_STEPS, ZERO_LR = 3, 1e-3
ZERO_F32_LAYERS, ZERO_UPDATE_FROB = 1, 1e-2
# Weights are drawn leaf by leaf on the card and placed at once, so no
# rank ever holds more than one full leaf of them.
ZERO_CHUNK = 1 << 24            # elements a fingerprint pass
# What the parent may still hold when the world starts: a margin for
# small buffers that outlive the earlier phases (their models, sessions
# and cuBLAS's workspaces are freed by then).
ZERO_PARENT_BYTES = 64 << 20


def zero_sums(got: torch.Tensor, want: torch.Tensor) -> list[float]:
    """[sum (got - want)^2, sum want^2, sum got^2, sum got * want, max
    |got - want|] in f64 over chunks of ZERO_CHUNK elements (a full f64
    copy of the embedding is 4.2 GB): partial sums that add over the
    blocks of a leaf."""
    got, want = got.reshape(-1), want.reshape(-1)
    out = [0.0] * 5
    for lo in range(0, got.numel(), ZERO_CHUNK):
        a = got[lo:lo + ZERO_CHUNK].double()
        b = want[lo:lo + ZERO_CHUNK].double()
        d = a - b
        out[0] += float(d.square().sum())
        out[1] += float(b.square().sum())
        out[2] += float(a.square().sum())
        out[3] += float((a * b).sum())
        out[4] = max(out[4], float(d.abs().max()) if d.numel() else 0.0)
    return out


def zero_gaps(sums) -> tuple[float, float, float]:
    """(relative Frobenius gap, largest elementwise gap, cosine) from
    ``zero_sums``."""
    dd, ww, gg, gw, top = sums
    return (math.sqrt(dd) / max(math.sqrt(ww), 1e-300), top,
            gw / max(math.sqrt(gg * ww), 1e-300))


def world_rows(values: list, dtype) -> torch.Tensor:
    """Every rank's (nested) list of numbers, the same shape on each, as
    a CPU tensor with a leading world axis, the same on every rank."""
    import torch.distributed as dist
    x = torch.tensor(values, dtype=dtype)
    out = torch.empty((dist.get_world_size(),) + tuple(x.shape),
                      dtype=dtype)
    dist.all_gather_into_tensor(out, x[None])
    return out


def owns(s) -> bool:
    """Whether this rank counts its shard of a leaf laid out by ``s`` (the
    one at index 0 of every mesh axis that replicates it)."""
    at = s.coordinate()
    return all(at[a] == 0 for a in s.replicated_axes)


def zero_note(rank: int, msg: str) -> None:
    """A progress line from rank 0, with the card's memory as it sees
    it."""
    if rank == 0:
        free, total = torch.cuda.mem_get_info()
        here = torch.cuda.memory_allocated() / 2**30
        print(f"  phase 15 rank 0: {msg}; {here:.2f} GiB allocated here, "
              f"{(total - free) / 2**30:.2f} GiB in use on the card",
              flush=True)


def zero_cfg(part: str):
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH)
    if part == "a":
        return dataclasses.replace(cfg, n_layers=ZERO_LAYERS)
    return dataclasses.replace(cfg, n_layers=ZERO_F32_LAYERS,
                               dtype="float32", zero3=True)


def zero_draw(cfg, device, seed: int, shardings=None, soften=False):
    """The model's parameter tree drawn on ``device`` as ``build(cfg)
    .init(generator).tree()`` draws it (leaf by leaf, a stacked leaf
    layer by layer), wq and wk scaled by TRAIN_CPU_SOFTEN with
    ``soften``; with ``shardings`` each leaf is placed (this rank's
    shard) as soon as it is drawn."""
    from repro_torch.models import build
    from repro_torch.models.base import init_leaf, leaves, unflatten
    gen = torch.Generator(device).manual_seed(seed)
    decls = build(cfg, device="meta").decls()
    sh = (dict(leaves(shardings)) if shardings is not None else None)
    out = []
    for path, p in leaves(decls):
        full = torch.empty(p.shape, dtype=torch.float32, device=device)
        for x in (full.unbind(0) if path[0] == "layers" else [full]):
            init_leaf(x, p, gen)
        if soften and path[-1] in ("wq", "wk") and "attn" in path:
            full.mul_(TRAIN_CPU_SOFTEN)
        out.append(full if sh is None else sh[path].place(full))
        del full
    return unflatten(decls, out)


def fingerprint(t: torch.Tensor, bounds=None, full=None) -> int:
    """sum_i bits_i * (2 i + 1) mod 2^64 over a leaf's elements, their bit
    patterns as integers and i their flat index in the full array
    (``full``, of which ``t`` is the block at ``bounds``; by default ``t``
    itself), in int64 on the tensor's device.  Integer sums are exact in
    any order, so the blocks' values add up to the full array's; two
    arrays that differ in one element always differ here (odd weights),
    in several only by a 64-bit coincidence."""
    if bounds is None:
        bounds, full = tuple((0, n) for n in t.shape), tuple(t.shape)
    stride = [math.prod(full[d + 1:]) for d in range(len(full))]
    dev = t.device
    bits = t.detach().reshape(1, -1) if t.dim() == 0 else t.detach()
    bits = bits.view({4: torch.int32, 2: torch.int16}[t.element_size()])
    rows = bits.shape[0]
    offs = torch.zeros((), dtype=torch.int64, device=dev)
    for d in range(1, bits.dim()):
        lo, hi = bounds[d]
        ax = torch.arange(lo, hi, dtype=torch.int64, device=dev) * stride[d]
        offs = offs[..., None] + ax
    offs = offs.reshape(1, -1)
    bits = bits.reshape(rows, -1)
    step = max(1, ZERO_CHUNK // max(bits.shape[1], 1))
    lo0 = bounds[0][0] if t.dim() else 0
    s0 = stride[0] if t.dim() else 0
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for r in range(0, rows, step):
        b = bits[r:r + step].to(torch.int64)
        idx = ((lo0 + torch.arange(r, r + b.shape[0], dtype=torch.int64,
                                   device=dev)) * s0)[:, None] + offs
        total += (b * (2 * idx + 1)).sum()
    return int(total) % 2**64


def signed(v: int) -> int:
    return v - 2**64 if v >= 2**63 else v


def zero_replicas(state, sh, mesh) -> tuple[int, int, int]:
    """Every local leaf of params, m and v fingerprinted on every rank;
    -> (leaves whose shard some ranks share, pairs of ranks that hold the
    same shard, pairs whose fingerprints differ)."""
    from repro_torch.models.base import leaves
    locs, shs = [], []
    for part in ("params", "m", "v"):
        locs += [t for _, t in leaves(getattr(state, part))]
        shs += [s for _, s in leaves(getattr(sh, part))]
    fps = world_rows([signed(fingerprint(t)) for t in locs], torch.int64)
    ranks = mesh.mesh.reshape(-1).tolist()
    at = {r: dict(zip(mesh.mesh_dim_names, c))
          for r, c in zip(ranks, np.ndindex(*mesh.mesh.shape))}
    shared = pairs = bad = 0
    for j, s in enumerate(shs):
        if all(s.sizes[a] == 1 for a in s.replicated_axes):
            continue
        shared += 1
        held = {}
        for r in ranks:
            key = tuple(at[r][a] for a in s.sizes
                        if a not in s.replicated_axes)
            if key in held:
                pairs += 1
                bad += int(fps[r, j] != fps[held[key], j])
            else:
                held[key] = r
    return shared, pairs, bad


def zero_state(params, model, gsh, moment_dtype, device):
    """A step-0 ``TrainState`` over this rank's parameter shards, with
    zero moments of ``gsh``'s shard shapes."""
    from repro_torch.models.base import leaves, unflatten
    from repro_torch.train import TrainState
    zeros = lambda: unflatten(params, [
        torch.zeros(s.shard_shape(p.shape), dtype=moment_dtype,
                    device=device)
        for (_, s), (_, p) in zip(leaves(gsh), leaves(model.decls()))])
    return TrainState(step=torch.zeros((), dtype=torch.int32,
                                       device=device),
                      params=params, m=zeros(), v=zeros())


def zero_shard_check(state, sh, model) -> tuple[int, int]:
    """-> (elements this rank holds, elements of the full state); raises
    if a local leaf's shape is not its spec's shard of the declared
    shape."""
    from repro_torch.models.base import leaves
    decls = dict(leaves(model.decls()))
    mine = full = 0
    for part in ("params", "m", "v"):
        for (path, t), (_, s) in zip(leaves(getattr(state, part)),
                                     leaves(getattr(sh, part))):
            whole = decls[path].shape
            if tuple(t.shape) != s.shard_shape(whole):
                raise AssertionError(f"{part} {path}: local {tuple(t.shape)}"
                                     f" is not the shard of {whole}")
            mine += t.numel()
            full += math.prod(whole)
    return mine, full


def zero_bf16(rank: int, mesh, device) -> dict:
    """(a) on one rank."""
    from repro_torch.models import ShardCtx, build, torch_dtype
    from repro_torch.sharding.rules import merged_rules
    from repro_torch.train import (AdamWConfig, make_train_step,
                                   state_shardings, zero_shardings)
    cfg = zero_cfg("a")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, ShardCtx(mesh, merged_rules(mesh)), device="meta")
    psh, gsh = zero_shardings(model, mesh)
    sh = state_shardings(psh, gsh)
    opt = AdamWConfig(lr=ZERO_LR, warmup_steps=1,
                      moment_dtype=torch_dtype(cfg.opt_moment_dtype))
    state = zero_state(zero_draw(cfg, device, SEED + 180, psh), model,
                       gsh, opt.moment_dtype, device)
    mine, full = zero_shard_check(state, sh, model)
    init_s = time.perf_counter() - t0
    zero_note(rank, f"(a) state placed in {init_s:.1f} s")
    step = make_train_step(model, opt, gsh, param_shardings=psh,
                           device=device)
    batch = train_batch(cfg, ZERO_ACCUM, ZERO_BATCH, ZERO_SEQ, SEED + 181)
    losses, norms, wall_ms, event_ms, replicas = [], [], [], [], []
    for i in range(ZERO_STEPS):
        s_ev = torch.cuda.Event(enable_timing=True)
        e_ev = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s_ev.record()
        state, metrics = step(state, batch, i)
        e_ev.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t1) * 1e3)
        event_ms.append(s_ev.elapsed_time(e_ev))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        replicas.append(zero_replicas(state, sh, mesh))
        zero_note(rank, f"(a) step {i}: loss {losses[-1]:.4f}, "
                        f"{wall_ms[-1]:.0f} ms")
    out = dict(params=model.n_params(), mine=mine, full=full,
               init_s=init_s, losses=losses, grad_norms=norms,
               wall_ms=wall_ms, event_ms=event_ms, replicas=replicas,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zero_one_device(rank: int, out_dir: str, device: str = "cuda") -> None:
    """(b)'s one-device step, in a process of its own: the loss, each
    leaf's gradient (``backward_into``) and update of one
    ``train_step``, written to ``out_dir`` for the world's rank 0; and the
    same again one ulp away (random signs), whose worst leaves are the
    floor of a comparison on this card."""
    from repro_torch.models import build
    from repro_torch.models.base import leaves, tree_map
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    from repro_torch.train.step import backward_into
    device = torch.device(device)
    cfg = zero_cfg("b")
    model = build(cfg, device="meta")
    opt = AdamWConfig(lr=TRAIN_CPU_LR, warmup_steps=1)
    batch = train_batch(cfg, 1, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, SEED + 183)
    gen = torch.Generator(device).manual_seed(SEED + 184)
    nudge = lambda t: t.mul_(1 + (torch.randint(
        0, 2, t.shape, generator=gen, device=device) * 2 - 1) * 2.0 ** -23)
    t0 = time.perf_counter()
    out, kept = {}, {}
    for tag in ("", "nudged"):
        tweak = nudge if tag else (lambda t: t)
        masters = tree_map(lambda t: tweak(t).requires_grad_(), zero_draw(
            cfg, device, SEED + 182, soften=True))
        loss = backward_into(model, masters, {k: torch.from_numpy(v[0]).to(
            device) for k, v in batch.items()})
        grads = {p: m.grad for p, m in leaves(masters)}
        del masters
        state = init_state(tree_map(tweak, zero_draw(
            cfg, device, SEED + 182, soften=True)), opt)
        before = {p: t.clone() for p, t in leaves(state.params)}
        state, metrics = make_train_step(model, opt, device=device)(
            state, batch, 0)
        upd = {p: t - before[p] for p, t in leaves(state.params)}
        del state, before
        if not tag:
            for p in grads:
                k = "/".join(map(str, p)).replace("/", ".")
                np.save(os.path.join(out_dir, f"grad_{k}.npy"),
                        grads[p].cpu().numpy())
                np.save(os.path.join(out_dir, f"upd_{k}.npy"),
                        upd[p].cpu().numpy())
            out.update(loss=float(loss), step_loss=float(metrics["loss"]),
                       grad_norm=float(metrics["grad_norm"]))
            kept = dict(grads=grads, upd=upd, loss=float(loss))
        else:
            ug = [zero_gaps(zero_sums(u, kept["upd"][p]))
                  for p, u in upd.items()]
            out["floor"] = dict(
                loss=abs(float(loss) - kept["loss"]) / abs(kept["loss"]),
                grad=max(zero_gaps(zero_sums(g, kept["grads"][p]))[0]
                         for p, g in grads.items()),
                update=max(x[0] for x in ug),
                gap=max(x[1] for x in ug) / (2 * TRAIN_CPU_LR),
                cos=min(x[2] for x in ug))
        del grads, upd
        gc.collect()
    out.update(seconds=time.perf_counter() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    with open(os.path.join(out_dir, "one.json"), "w") as f:
        json.dump(out, f)


def zero_f32(rank: int, mesh, device, out_dir: str):
    """(b) on one rank: one step on the same weights as the one-device
    process's; rank 0 holds every gathered leaf to its files.  -> (result,
    the state after the step, its shardings)."""
    from repro_torch.models import ShardCtx, build
    from repro_torch.models.base import leaves
    from repro_torch.sharding.rules import merged_rules
    from repro_torch.train import (AdamWConfig, apply_updates,
                                   make_train_step, state_shardings,
                                   zero_shardings)
    cfg = zero_cfg("b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, ShardCtx(mesh, merged_rules(mesh)), device="meta")
    psh, gsh = zero_shardings(model, mesh)
    opt = AdamWConfig(lr=TRAIN_CPU_LR, warmup_steps=1)
    state = zero_state(zero_draw(cfg, device, SEED + 182, psh, soften=True),
                       model, gsh, torch.float32, device)
    step = make_train_step(model, opt, gsh, param_shardings=psh,
                           device=device)
    batch = train_batch(cfg, 1, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, SEED + 183)
    zero_note(rank, "(b) state placed")
    loss, grads = step.grads(state, batch)
    state, metrics = apply_updates(state, grads, opt, param_shardings=psh,
                                   grad_shardings=gsh)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    zero_note(rank, f"(b) one step in {step_s:.1f} s")
    # The weights before the step, drawn again (a copy kept through the
    # step would cost every rank its size).  Each rank holds its own
    # blocks to the same blocks of the one-device files; the partial sums
    # of the ranks that own them add up to each leaf's gaps.
    before = zero_draw(cfg, device, SEED + 182, psh, soften=True)
    paths, sums = [], []
    for (path, g), (_, gs), (_, p), (_, s), (_, b) in zip(
            leaves(grads), leaves(gsh), leaves(state.params), leaves(psh),
            leaves(before)):
        k = "/".join(map(str, path)).replace("/", ".")
        paths.append("/".join(map(str, path)))
        for kind, t, sh_ in (("grad", g, gs), ("upd", p - b, s)):
            if not owns(sh_):
                sums.append([0.0] * 5)
                continue
            a = np.load(os.path.join(out_dir, f"{kind}_{k}.npy"),
                        mmap_mode="r")
            want = torch.from_numpy(np.array(a[tuple(
                slice(lo, hi) for lo, hi in sh_.bounds(a.shape))]))
            sums.append(zero_sums(t, want.to(device)))
            del want
    del grads, before
    rows = world_rows(sums, torch.float64)       # (world, leaves x 2, 5)
    total = rows.sum(0)
    total[:, 4] = rows[:, :, 4].max(0).values
    worst = {"grad": (0.0, ""), "update": (0.0, ""), "gap": (0.0, ""),
             "cos": (1.0, "")}
    for i, path in enumerate(paths):
        rel_g = zero_gaps(total[2 * i].tolist())[0]
        rel_u, top, cos = zero_gaps(total[2 * i + 1].tolist())
        for w, v in (("grad", rel_g), ("update", rel_u),
                     ("gap", top / (2 * TRAIN_CPU_LR)), ("cos", cos)):
            if (v < worst[w][0]) if w == "cos" else (v > worst[w][0]):
                worst[w] = (v, path)
    gc.collect()
    zero_note(rank, f"(b) compared ({time.perf_counter() - t0:.1f} s)")
    res = dict(loss=float(loss), grad_norm=float(
        metrics["grad_norm"]), step_s=step_s, worst=worst,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return res, state, state_shardings(psh, gsh), model


def state_fingerprints(state, sh, full: dict) -> list[int]:
    """Each leaf of params, m and v: the fingerprint of the full array,
    from this rank's block if it owns it (``full``: leaf path -> full
    shape) summed over the world; whole leaves without ``sh``."""
    from repro_torch.models.base import leaves
    mine = []
    for part in ("params", "m", "v"):
        tree = getattr(state, part)
        shs = (dict(leaves(getattr(sh, part))) if sh is not None else {})
        for path, t in leaves(tree):
            s = shs.get(path)
            if s is None:
                mine.append(fingerprint(t))
            elif owns(s):
                mine.append(fingerprint(t, s.bounds(full[path]),
                                        full[path]))
            else:
                mine.append(0)
    return mine


def zero_ckpt(rank: int, state, sh, model, device, out_dir: str) -> dict:
    """(c) on one rank: save (b)'s state, restore it on one device (rank
    0) and on a 1 x 4 mesh; every leaf's fingerprint (``fingerprint``,
    summed over the blocks of the ranks that own them) equals the live
    state's, so no array crosses the world to check it."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.base import leaves
    from repro_torch.train import (CheckpointManager, state_shardings,
                                   zero_shardings)
    ckpt = os.path.join(out_dir, "ckpt")
    full = {p: d.shape for p, d in leaves(model.decls())}
    total = lambda fps: [sum(int(x) for x in col) % 2**64
                         for col in world_rows([signed(f) for f in fps],
                                               torch.int64).T]
    live = total(state_fingerprints(state, sh, full))
    t0 = time.perf_counter()
    CheckpointManager(ckpt).save(1, state, shardings=sh)
    save_s = time.perf_counter() - t0
    zero_note(rank, f"(c) saved in {save_s:.1f} s")
    t1 = time.perf_counter()
    one_equal = True
    if rank == 0:
        # The template gives the tree and each leaf's device.
        one = CheckpointManager(ckpt).restore(state)[0]
        one_equal = (int(one.step) == 1
                     and state_fingerprints(one, None, full) == live)
        del one
        gc.collect()
        torch.cuda.empty_cache()
    one_s = time.perf_counter() - t1
    mesh14 = make_debug_mesh(1, 4, device_type=device.type)
    sh14 = state_shardings(*zero_shardings(model, mesh14))
    t2 = time.perf_counter()
    m14, _ = CheckpointManager(ckpt).restore(state, shardings=sh14)
    m14_s = time.perf_counter() - t2
    zero_shard_check(m14, sh14, model)
    m14_equal = (int(m14.step) == 1
                 and total(state_fingerprints(m14, sh14, full)) == live)
    del m14
    gc.collect()
    torch.cuda.empty_cache()
    files = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(ckpt) for f in fs)
    return dict(save_s=save_s, one_s=one_s, m14_s=m14_s, leaves=len(live),
                one_equal=bool(one_equal), m14_equal=bool(m14_equal),
                bytes=files)


def zero_rank(rank: int, out_dir: str, device: str = "cuda") -> None:
    """Phase 15 on one rank of the gloo world: (a), (b), (c); writes
    ``zero_rank<rank>.json``."""
    from repro_torch.launch.mesh import make_debug_mesh
    dev = torch.device(device)
    if dev.type == "cuda":
        # Four processes share the card: each returns what it frees.
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        torch.cuda.set_device(0)
    mesh = make_debug_mesh(*ZERO_MESH, device_type=dev.type)
    res = dict(rank=rank, coordinate=list(mesh.get_coordinate()),
               context_gib=torch.cuda.memory_reserved() / 2**30)
    res["a"] = zero_bf16(rank, mesh, dev)
    res["b"], state, sh, model = zero_f32(rank, mesh, dev, out_dir)
    res["c"] = zero_ckpt(rank, state, sh, model, dev, out_dir)
    with open(os.path.join(out_dir, f"zero_rank{rank}.json"), "w") as f:
        json.dump(res, f)


def zero_path(card: str) -> dict:
    """Phase 15: ZeRO training in a gloo world of four on the card."""
    import tempfile
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    gc.collect()
    before = torch.cuda.memory_allocated()
    # cuBLAS keeps a 32 MiB workspace for every stream it has run on (the
    # graph captures of phase 10 used many), allocated through the caching
    # allocator; it makes them again on demand.
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"phase 15: the parent holds {held / 2**20:.1f} MiB of CUDA "
          f"memory ({torch.cuda.memory_reserved() / 2**20:.1f} MiB "
          f"reserved) before the spawn, {before / 2**20:.1f} MiB before "
          f"cuBLAS's per-stream workspaces were freed")
    if held > ZERO_PARENT_BYTES:
        live = sorted(((t.numel() * t.element_size(), tuple(t.shape),
                        t.dtype) for t in gc.get_objects()
                       if isinstance(t, torch.Tensor) and t.is_cuda),
                      key=lambda x: -x[0])[:8]
        fail(f"phase 15: the parent holds {held} bytes of CUDA memory; the "
             f"largest live tensors: {live}")
    with tempfile.TemporaryDirectory() as tmp:
        spawn(zero_one_device, 1, tmp, init_method=f"file://{tmp}/store1")
        one = json.load(open(os.path.join(tmp, "one.json")))
        t1 = time.perf_counter()
        spawn(zero_rank, ZERO_WORLD, tmp, "cuda",
              init_method=f"file://{tmp}/store4")
        world_s = time.perf_counter() - t1
        ranks = [json.load(open(os.path.join(tmp, f"zero_rank{r}.json")))
                 for r in range(ZERO_WORLD)]
    a0, b0, c0 = ranks[0]["a"], ranks[0]["b"], ranks[0]["c"]
    cfg = zero_cfg("a")
    print(f"phase 15 (a) {TRAIN_ARCH} x {ZERO_LAYERS} layers at full width "
          f"(d {cfg.d_model}, d_ff {cfg.d_ff}, V {cfg.vocab}), "
          f"{a0['params']:,} f32 master parameters, zero3 {cfg.zero3}, "
          f"{cfg.dtype} compute, remat {cfg.remat}, {ZERO_STEPS} steps of "
          f"{ZERO_ACCUM} x {ZERO_BATCH} x {ZERO_SEQ} on a "
          f"{ZERO_MESH[0]} x {ZERO_MESH[1]} gloo mesh: losses "
          + ", ".join(f"{x:.4f}" for x in a0["losses"]) + "; grad norms "
          + ", ".join(f"{x:.4g}" for x in a0["grad_norms"]) + f"; {card}")
    for r in ranks:
        a = r["a"]
        print(f"  rank {r['rank']} at {tuple(r['coordinate'])}: holds "
              f"{a['mine']:,} of {a['full']:,} state elements "
              f"({100 * a['mine'] / a['full']:.1f}%), peak "
              f"{a['peak_gib']:.2f} GiB (torch.cuda.max_memory_allocated; "
              f"context {r['context_gib']:.2f} GiB reserved at start), "
              f"steps " + ", ".join(f"{x:.0f}" for x in a["wall_ms"])
              + " ms host wall (" + ", ".join(f"{x:.0f}" for x in
                                             a["event_ms"])
              + " ms CUDA events), init "
              f"{a['init_s']:.1f} s; replicated shards after each step: "
              + "; ".join(f"{s} leaves, {p} pairs, {d} differ"
                          for s, p, d in a["replicas"]))
    losses = [r["a"]["losses"] for r in ranks]
    if any(x != losses[0] for x in losses):
        fail(f"phase 15 (a): ranks report different losses {losses}")
    if not all(np.isfinite(losses[0])) or not losses[0][-1] < losses[0][0]:
        fail(f"phase 15 (a): loss did not fall: {losses[0]}")
    if any(d for r in ranks for _, _, d in r["a"]["replicas"]) or not all(
            p for r in ranks for _, p, _ in r["a"]["replicas"]):
        fail("phase 15 (a): replicated shards differ across ranks")
    if any(r["a"]["mine"] >= r["a"]["full"] for r in ranks):
        fail("phase 15 (a): a rank holds the whole state")
    loss_rel = abs(b0["loss"] - one["step_loss"]) / abs(one["step_loss"])
    w = b0["worst"]
    print(f"phase 15 (b) {TRAIN_ARCH} x {ZERO_F32_LAYERS} layer f32, zero3, "
          f"wq and wk x {TRAIN_CPU_SOFTEN}, B = {TRAIN_CPU_BATCH}, S = "
          f"{TRAIN_CPU_SEQ}, lr {TRAIN_CPU_LR}: the world against one device"
          f" (its own process, {one['seconds']:.1f} s, peak "
          f"{one['peak_gib']:.2f} GiB): loss {b0['loss']:.7f} / "
          f"{one['step_loss']:.7f} (rel {loss_rel:.2e}, bound "
          f"{TRAIN_CPU_LOSS_RTOL}); grad norm {b0['grad_norm']:.6g} / "
          f"{one['grad_norm']:.6g}; worst gradient {w['grad'][0]:.2e} "
          f"{w['grad'][1]} (bound {TRAIN_CPU_GRAD_FROB}); worst update "
          f"{w['update'][0]:.2e} {w['update'][1]} (bound "
          f"{max(ZERO_UPDATE_FROB, one['floor']['update']):.2e}: "
          f"{ZERO_UPDATE_FROB} or the floor below), largest update gap {w['gap'][0]:.3f} of "
          f"2 lr, least update cosine {w['cos'][0]:.5f}; one device one "
          f"ulp from itself: loss {one['floor']['loss']:.2e}, gradient "
          f"{one['floor']['grad']:.2e}, update {one['floor']['update']:.2e}"
          f" (cosine {one['floor']['cos']:.5f}); world step "
          f"{b0['step_s']:.1f} s with init, peaks "
          + ", ".join(f"{r['b']['peak_gib']:.2f}" for r in ranks)
          + f" GiB; {card}")
    if not loss_rel <= TRAIN_CPU_LOSS_RTOL:
        fail(f"phase 15 (b): loss {b0['loss']} one device "
             f"{one['step_loss']}")
    if not w["grad"][0] <= TRAIN_CPU_GRAD_FROB:
        fail(f"phase 15 (b): gradient {w['grad']}")
    # Adam's first step moves an element by lr x the sign of its
    # gradient, so an element whose gradient sits at the noise level
    # moves the other way: one device one ulp from itself is as far from
    # its own update as the floor printed above.  Each leaf's update is
    # held to ZERO_UPDATE_FROB or that floor, whichever is larger, and to
    # phase 14 (b)'s gates: no element off by more than 2 lr, a cosine of
    # TRAIN_CPU_UPDATE_COS.
    bound = max(ZERO_UPDATE_FROB, one["floor"]["update"])
    if not (w["update"][0] <= bound and w["gap"][0] <= 1.0
            and w["cos"][0] >= TRAIN_CPU_UPDATE_COS):
        fail(f"phase 15 (b): update {w['update']} (bound {bound}), gap "
             f"{w['gap']}, cosine {w['cos']}")
    print(f"phase 15 (c) the (b) state saved from the world "
          f"({c0['bytes'] / 2**30:.2f} GiB of files, {c0['save_s']:.1f} s), "
          f"restored on one device ({c0['one_s']:.1f} s) and on a 1 x 4 "
          f"mesh ({c0['m14_s']:.1f} s): {c0['leaves']} leaves, each leaf's "
          f"fingerprint (a position-weighted 64-bit sum of its bits, "
          f"which any one differing element changes) equal to the live "
          f"state's: one device {c0['one_equal']}, 1 x 4 on every rank "
          f"{all(r['c']['m14_equal'] for r in ranks)}")
    if not c0["one_equal"] or not all(r["c"]["m14_equal"] for r in ranks):
        fail("phase 15 (c): a restored leaf differs from the gathered state")
    wall = time.perf_counter() - t0
    print(f"phase 15 (d): ZeRO path done in {wall:.1f} s (the world "
          f"{world_s:.1f} s, the one-device process "
          f"{one['seconds']:.1f} s of its own work); {card}")
    return dict(ranks=ranks, one=one, seconds=wall)


# -- phase 16 --------------------------------------------------------------

# Tensor-parallel compute over the model axis in one gloo world of
# TP_WORLD on the card (the (2, 2) and (1, 4) meshes of that world),
# held to one-device runs of the same models in a process of their own:
# (a) llama3-8b and (b) deepseek-v2-lite-16b (its dense front layer and
# one MoE layer of 64 experts) on 2 x 2, (c) qwen2-vl-2b with
# TP_IMAGE patch embeddings and M-RoPE positions on 1 x 4, (f)
# rwkv6-7b on 2 x 2 and (g) zamba2-7b on 1 x 4 (one group of 6 mamba
# layers, the shared block and one tail layer: zamba2-7b's 14704-wide
# in_proj is 3676 columns a rank, blocks that cut across z | x | B | C |
# dt), each at full width and TP_LAYERS layers deep (TP_DEPTH for
# zamba2), random weights from a seed: a prefill of LM_BATCH x
# LM_PROMPT and LM_DECODE decode steps fed the one-device run's greedy
# tokens; each layer teacher-forced (its one-device input) at
# LM_LAYER_BOUNDS, the logits end to end at TP_E2E_BOUNDS; ZeRO + TP
# AdamW steps of phase 15 (a)'s batch (TP_TRAIN: (a), (f), (g)), and
# the CoTM head on the pooled prefill states of (a), (f) and (g)
# through ``fused_cotm`` ((e), TP_HEADS); (d) ``chunked_attention``'s
# context-parallel leg on 1 x 4 at TP_CP's shapes, within TP_CP_BOUND
# of one device (tests/test_sharding.py's bound).  Phase 15 (b) holds
# one f32 layer of this same train step to one device for llama3-8b,
# and (f) for rwkv6-7b at its bounds (TP_F32_ARCH).
TP_WORLD, TP_LAYERS, TP_IMAGE = 4, 2, 16
TP_ARCHS = (("llama3-8b", (2, 2)), ("deepseek-v2-lite-16b", (2, 2)),
            ("qwen2-vl-2b", (1, 4)), ("rwkv6-7b", (2, 2)),
            ("zamba2-7b", (1, 4)))
TP_TAGS = "abcfg"
TP_DEPTH = {"zamba2-7b": 7}
TP_HEADS = ("llama3-8b", "rwkv6-7b", "zamba2-7b")
TP_STEPS = ZERO_STEPS
# (architecture, mesh, steps): the ZeRO + TP steps of (a), (f), (g)
TP_TRAIN = (("llama3-8b", (2, 2), TP_STEPS), ("rwkv6-7b", (2, 2), TP_STEPS),
            ("zamba2-7b", (1, 4), 1))
TP_F32_ARCH = "rwkv6-7b"
# (shape (B, S, H, D), dtype, q_chunk, k_chunk): the reference test's,
# and a long bf16 sequence at head_dim 128 with the configs' chunks.
TP_CP = (((4, 256, 6, 16), torch.float32, 64, 64),
         ((2, 4096, 6, 128), torch.bfloat16, 512, 2048))
TP_CP_BOUND = 2e-2
# (median, p99, max) of |TP - one device| / max |one device| over the
# prefill's and the 16 steps' logits, and the least share of positions
# whose argmax agrees, set from TP's own readings on the H100 (700 W):
# median 3.05e-3 / 3.25e-3 / 1.49e-3, p99 5.15e-2 / 2.60e-2 / 7.25e-2,
# max 0.192 / 0.0723 / 0.289, argmax 0.882 / 0.956 / 0.927 for (a) /
# (b) / (c).  Room: about 3x the largest median, 2x the largest p99,
# 1.5x the largest max.  The max is one logit of 68 x V, where a bf16
# rounding that TP's other sum order flips has turned the init's nearly
# one-hot attention to another key; it catches a gross fault (a wrong
# block or layer moves it to ~1) and no more.  The tight gate is the
# teacher-forced one (LM_LAYER_BOUNDS), where one layer's rounding, not
# its propagation, sets the gap.
TP_E2E_BOUNDS, TP_E2E_ARGMAX = (1e-2, 1.5e-1, 4.5e-1), 0.75
TP_HEADS_NOTE = (
    "no full-width config takes this leg on 4 ranks: the ten configs "
    "have 12, 16, 24, 32, 48 or 64 heads, and each divides a model axis "
    "of 2 or 4 (the reference takes it for starcoder2's 24 and "
    "qwen2-vl's 12 heads on its 16-wide axis)")


def tp_cfg(name: str):
    from repro_torch.configs import get_config
    cfg = get_config(name)
    n_front = cfg.moe.first_dense_layers if cfg.moe else 0
    return dataclasses.replace(cfg, n_layers=TP_DEPTH.get(
        name, max(TP_LAYERS, n_front + 1)))


def tp_inputs(cfg, index: int, device):
    """The prompt of (a)-(c): tokens, positions and (vlm) patch
    embeddings on ``device``."""
    rng = np.random.default_rng(SEED + 190 + index)
    n_img = TP_IMAGE if cfg.rope_style == "mrope" else 0
    return tuple(None if x is None else x.to(device)
                 for x in lm_inputs(cfg, LM_BATCH, LM_PROMPT, rng, n_img))


def tp_walk(model, tokens, positions, extra, max_len: int, fed=None,
            forced=None, lay=None) -> dict:
    """A prefill and LM_DECODE decode steps layer by layer, as
    ``prefill`` / ``decode_step`` run them (``layer_runs``): each layer's
    input and output (whole: every row, every position) and the logits
    (whole over the vocab and the rows).  The steps feed ``fed`` (B,
    LM_DECODE), else the greedy tokens; with ``forced`` (another walk's
    record) every layer takes that walk's input to it (teacher forcing).
    ``lay`` takes this rank's block of a whole input by logical axes."""
    from repro_torch.launch.specs import decode_axes, prefill_axes
    cfg, ctx = model.cfg, model.ctx
    lay = lay or (lambda t, axes: t)
    pa, da = prefill_axes(cfg), decode_axes(cfg)
    B, S = tokens.shape[0], positions.shape[-1]
    rows = lambda t: ctx.gather_rows(t, B)
    whole = lambda t: rows(model.gather_vocab(t))
    embed = lambda t, e=None: (model.embed(t) if e is None
                               else model.embed(t, e))
    rec = dict(ins=[], outs=[], dec_ins=[], dec_outs=[], logits=[],
               fed=[])
    fns, states = layer_runs(model, max_len), []
    pos = lay(positions, pa["positions"])
    with torch.no_grad():
        x = x0 = embed(lay(tokens, pa["tokens"]), None if extra is None
                       else lay(extra, pa["extra_embeds"]))
        for i, fn in enumerate(fns):
            if forced is not None:
                x = lay(forced["ins"][i], ("batch", "seq", None))
            rec["ins"].append(rows(ctx.gather_seq(x, S)))
            x, st = fn(x, x0, pos, S, None)
            rec["outs"].append(rows(ctx.gather_seq(x, S)))
            states.append(st)
        rec["logits"].append(whole(model.logits(model.last_position(x, S))))
        nxt = rec["logits"][0].argmax(-1)
        for t in range(LM_DECODE):
            tok = fed[:, t:t + 1] if fed is not None else nxt
            rec["fed"].append(tok)
            p_t = lay(positions[..., -1:] + 1 + t, da["positions"])
            x = x0 = embed(lay(tok, da["tokens"]))
            di, do = [], []
            for i, fn in enumerate(fns):
                if forced is not None:
                    x = lay(forced["dec_ins"][t][i], ("batch", None, None))
                di.append(rows(x))
                x, states[i] = fn(x, x0, p_t, 1, states[i])
                do.append(rows(x))
            rec["dec_ins"].append(di)
            rec["dec_outs"].append(do)
            rec["logits"].append(whole(model.logits(x)))
            nxt = rec["logits"][-1].argmax(-1)
    rec["fed"] = torch.cat(rec["fed"], 1)
    rec["logits"] = torch.cat(rec["logits"], 1)
    return rec


def tp_f32_cfg():
    """(f)'s f32 check: one layer of TP_F32_ARCH in f32, ZeRO-3, as phase
    15 (b) holds llama3-8b."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(TP_F32_ARCH),
                               n_layers=ZERO_F32_LAYERS, dtype="float32",
                               zero3=True)


def tp_f32_one(out_dir: str, dev) -> None:
    """(f)'s one-device f32 loss and gradient, written to ``out_dir``
    (``tp_f32.pt``, read back with mmap by the world's ranks)."""
    from repro_torch.models import build
    from repro_torch.models.base import leaves, tree_map
    from repro_torch.train.step import backward_into
    cfg = tp_f32_cfg()
    batch = train_batch(cfg, 1, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, SEED + 187)
    masters = tree_map(lambda t: t.requires_grad_(), zero_draw(
        cfg, dev, SEED + 186))
    loss = backward_into(build(cfg, device="meta"), masters, {
        k: torch.from_numpy(v[0]).to(dev) for k, v in batch.items()})
    torch.save(dict(loss=float(loss), grads={
        "/".join(map(str, p)): m.grad.cpu() for p, m in leaves(masters)}),
        os.path.join(out_dir, "tp_f32.pt"))
    del masters
    gc.collect()
    torch.cuda.empty_cache()


def tp_one_device(rank: int, out_dir: str, device: str = "cuda") -> None:
    """(a)-(c), (f), (g) on one device, in a process of its own: each
    model's greedy walk (``tp_walk``) written to ``out_dir``
    (``torch.save``); for deepseek also the aux loss of each data shard's
    rows; and (f)'s f32 gradient (``tp_f32_one``)."""
    from repro_torch.models import build
    dev = torch.device(device)
    tp_f32_one(out_dir, dev)
    for i, (name, shape) in enumerate(TP_ARCHS):
        cfg = tp_cfg(name)
        t0 = time.perf_counter()
        model = build(cfg, device=dev).init(
            torch.Generator(dev).manual_seed(SEED + 195 + i))
        tokens, positions, extra = tp_inputs(cfg, i, dev)
        max_len = positions.shape[-1] + LM_DECODE
        rec = tp_walk(model, tokens, positions, extra, max_len)
        if cfg.moe is not None:
            n = LM_BATCH // shape[0]
            with torch.no_grad():
                rec["aux"] = sum(float(model.hidden(
                    tokens[j * n:(j + 1) * n], positions[j * n:(j + 1) * n]
                    if positions.ndim == 2 else positions[:, j * n:(j + 1)
                                                          * n])[1])
                    for j in range(shape[0])) / shape[0]
        rec["seconds"] = time.perf_counter() - t0
        rec["params"] = model.n_params()
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.save(tree_to_cpu(rec), os.path.join(out_dir, f"tp_one_{i}.pt"))
        del model, rec
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def tree_to_cpu(tree):
    if isinstance(tree, dict):
        return {k: tree_to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to_cpu(v) for v in tree]
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def tp_traffic(fn, weights: set, crossed: list):
    """-> (fn(), the bytes this rank sent over each mesh axis in it);
    appends to ``crossed`` each collective over the model axis whose
    tensor has a shape in ``weights``."""
    from repro_torch.sharding import layout
    with layout.record_traffic() as sent:
        out = fn()
    crossed += [r for r in sent.calls
                if r[1] == "model" and r[2] in weights]
    return out, sent.bytes


def weight_shapes(model, ctx) -> set:
    """The shape of each weight that the rules split over the model axis,
    whole and as a rank's block (one layer's of a stacked leaf), less the
    shapes of the weights they do not split: the gradients of those,
    partial sums over the axis, are summed over it in a train step
    (zamba2's ``ln_in`` is as wide as the mamba ``norm``)."""
    from repro_torch.models.base import leaves
    split, whole = set(), set()
    for path, p in leaves(model.decls()):
        block = ctx.sharding(p.shape, p.axes).shard_shape(p.shape)
        for shape in (p.shape, block):
            (whole if block == tuple(p.shape) else split).add(
                tuple(shape[1:] if path[0] == "layers" else shape))
    return split - whole


def tp_serve(rank: int, i: int, name: str, mesh, device, one: dict) -> dict:
    """(a)-(c) on one rank: the TP model (this rank's blocks of the
    one-device weights: the same draws), the prefill and decode steps
    timed, held end to end and layer by layer to the one-device walk."""
    from repro_torch.launch.specs import decode_axes, prefill_axes
    from repro_torch.models import ShardCtx, build
    from repro_torch.sharding.rules import merged_rules
    cfg = tp_cfg(name)
    ctx = ShardCtx(mesh, merged_rules(mesh))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, ctx, device=device).init(
        torch.Generator(device).manual_seed(SEED + 195 + i))
    mine = sum(p.numel() for p in model.parameters())
    mine_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    init_s = time.perf_counter() - t0
    tokens, positions, extra = tp_inputs(cfg, i, device)
    max_len = positions.shape[-1] + LM_DECODE
    lay = lambda t, axes: ctx.local(t, *axes).to(device)
    pa, da = prefill_axes(cfg), decode_axes(cfg)
    weights, crossed = weight_shapes(model, ctx), []
    B = tokens.shape[0]
    whole = lambda t: ctx.gather_rows(model.gather_vocab(t), B)
    fed = one["fed"].to(device)
    args = (lay(tokens, pa["tokens"]), lay(positions, pa["positions"]),
            max_len, None if extra is None else lay(extra,
                                                     pa["extra_embeds"]))
    with torch.no_grad():
        model.prefill(*args)          # warm: the first call's set-up
    # the entry points a user calls, between CUDA events: the prefill,
    # then the decode steps fed the one-device run's tokens
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    before_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()      # the prefill's own (phase 17)
    w0 = time.perf_counter()
    ev[0].record()
    with torch.no_grad():
        (logits, cache), pre_bytes = tp_traffic(
            lambda: model.prefill(*args), weights, crossed)
    ev[1].record()
    torch.cuda.synchronize()
    pre_wall = (time.perf_counter() - w0) * 1e3
    pre_peak = torch.cuda.max_memory_allocated()
    got = [whole(logits)]
    step_ms, step_wall, step_bytes = [], [], []
    last = positions[..., -1:]
    for t in range(LM_DECODE):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        w1 = time.perf_counter()
        e[0].record()
        with torch.no_grad():
            (logits, cache), b = tp_traffic(lambda: model.decode_step(
                cache, lay(fed[:, t:t + 1], da["tokens"]),
                lay(last + 1 + t, da["positions"])), weights, crossed)
        e[1].record()
        torch.cuda.synchronize()
        step_wall.append((time.perf_counter() - w1) * 1e3)
        step_ms.append(e[0].elapsed_time(e[1]))
        step_bytes.append(b)
        got.append(whole(logits))
    got = torch.cat(got, 1)
    res = dict(name=name, mine=mine, full=model.n_params(), init_s=init_s,
               mine_bytes=mine_bytes, prefill_peak=pre_peak,
               prefill_ms=ev[0].elapsed_time(ev[1]), prefill_wall_ms=pre_wall,
               step_ms=step_ms, step_wall_ms=step_wall,
               prefill_bytes=pre_bytes, step_bytes=step_bytes,
               crossed=[list(map(str, r)) for r in crossed],
               greedy=got.argmax(-1).cpu().tolist())
    forced = tp_walk(model, tokens, positions, extra, max_len, fed=fed,
                     forced=one, lay=lay)
    if rank == 0:
        res["e2e"] = lm_gate(f"phase 16 {name} TP vs one device, prefill "
                             f"and {LM_DECODE} steps", got.cpu(),
                             one["logits"], TP_E2E_BOUNDS, TP_E2E_ARGMAX)
        res["layers"] = layer_gate(
            f"phase 16 {name}", [x.cpu() for x in forced["outs"]]
            + [x.cpu() for d in forced["dec_outs"] for x in d],
            one["outs"] + [x for d in one["dec_outs"] for x in d],
            f"TP vs one device, teacher-forced, {len(forced['outs'])} "
            f"layers, the prefill and {LM_DECODE} steps")
        res["greedy_equal"] = float((got.argmax(-1).cpu()[:, :LM_DECODE]
                                     == one["fed"]).double().mean())
    if cfg.moe is not None:
        with torch.no_grad():
            _, aux = model.hidden(lay(tokens, pa["tokens"]),
                                  lay(positions, pa["positions"]))
        res["aux"] = float(aux)
    if name in TP_HEADS:
        res["head"] = tp_head(rank, model, tokens, positions, lay, pa,
                              device)
    del model, cache, forced
    gc.collect()
    torch.cuda.empty_cache()
    res["peak_gib"] = max(before_peak, torch.cuda.max_memory_allocated()
                          ) / 2**30
    return res


def tp_head(rank: int, model, tokens, positions, lay, pa, device) -> dict:
    """(e) the CoTM head on the pooled prefill states, whole over the
    rows and positions on every rank (``hidden(..., batch=)``), scored
    through ``fused_cotm`` on rank 0 in its own launch-count window,
    bit for bit against ``fused_cotm_ref``."""
    from repro_torch import kernels
    from repro_torch.models import TMHead, TMHeadConfig, pool_features
    with torch.no_grad():
        hidden, _ = model.hidden(lay(tokens, pa["tokens"]),
                                 lay(positions, pa["positions"]),
                                 batch=tokens.shape[0])
    feats = pool_features(hidden)
    if rank != 0:
        return {}
    head = TMHead(TMHeadConfig(), d_features=model.cfg.d_model)
    hp = tm_head_params(head.cotm_cfg.n_literals, head.cfg.n_clauses,
                        head.cfg.n_classes, head.cfg.n_states, SEED + 123,
                        device)
    kernels.reset_launch_counts()
    scores, err = head_scores("phase 16 TM head scores", head, hp, feats)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["fused_cotm_i32"]
    return dict(launches=launches, err=err, shape=list(feats.shape),
                K=head.cotm_cfg.n_literals,
                nonzero=int((scores != 0).sum()), n=scores.numel())


def tp_blocks(step, state, model) -> bool:
    """Whether every parameter the ZeRO step computes on (``gathered``:
    this rank's shards gathered over the data axes) is this rank's block
    under its ``ShardCtx.model_spec``, and some are split: the step
    computes tensor parallel.  Every rank calls it (it gathers)."""
    from repro_torch.models.base import leaves
    decls = [p for _, p in leaves(model.decls())]
    want = [model.ctx.model_block(p.shape, p.axes) for p in decls]
    got = [tuple(t.shape) for t in step.gathered(state.params)]
    return got == want and any(w != p.shape for w, p in zip(want, decls))


def tp_train(rank: int, name: str, mesh, steps: int, device) -> dict:
    """ZeRO + TP AdamW steps of phase 15 (a)'s batch on ``name`` at
    ``tp_cfg``'s depth: the losses, the bytes each step sends, each
    rank's share of the state, replicated shards and peak memory."""
    from repro_torch.models import ShardCtx, build, torch_dtype
    from repro_torch.sharding.rules import merged_rules
    from repro_torch.train import (AdamWConfig, make_train_step,
                                   state_shardings, zero_shardings)
    cfg = tp_cfg(name)
    seed = SEED + 180 + 10 * [n for n, _, _ in TP_TRAIN].index(name)
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, ShardCtx(mesh, merged_rules(mesh)), device="meta")
    psh, gsh = zero_shardings(model, mesh)
    sh = state_shardings(psh, gsh)
    opt = AdamWConfig(lr=ZERO_LR, warmup_steps=1,
                      moment_dtype=torch_dtype(cfg.opt_moment_dtype))
    state = zero_state(zero_draw(cfg, device, seed, psh), model, gsh,
                       opt.moment_dtype, device)
    mine, full = zero_shard_check(state, sh, model)
    step = make_train_step(model, opt, gsh, param_shardings=psh,
                           device=device)
    if not tp_blocks(step, state, model):
        fail(f"phase 16 {name}: the train step does not compute on this "
             f"rank's model-axis blocks")
    batch = train_batch(cfg, ZERO_ACCUM, ZERO_BATCH, ZERO_SEQ, seed + 1)
    losses, wall_ms, sent, replicas = [], [], [], []
    weights, crossed = weight_shapes(model, model.ctx), []
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()      # the steps' own (phase 17)
    for i in range(steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (state, metrics), b = tp_traffic(lambda: step(state, batch, i),
                                         weights, crossed)
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(metrics["loss"]))
        sent.append(b)
        replicas.append(zero_replicas(state, sh, mesh))
    steps_peak = torch.cuda.max_memory_allocated()
    out = dict(losses=losses, wall_ms=wall_ms, bytes=sent,
               replicas=replicas, mine=mine, full=full,
               crossed=[list(map(str, r)) for r in crossed],
               state_bytes=state_bytes(state), steps_peak=steps_peak,
               peak_gib=max(init_peak, steps_peak) / 2**30)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_f32(rank: int, mesh, device, out_dir: str) -> dict:
    """(f)'s f32 check on one rank: the loss and the gradient of one
    ZeRO + TP step of ``tp_f32_cfg`` on the weights and batch of
    ``tp_f32_one``; each rank holds its own blocks of each gradient to
    the same blocks of the one-device file (mmap), and the partial sums
    of the ranks that own them add up to each leaf's gaps."""
    from repro_torch.models import ShardCtx, build
    from repro_torch.models.base import leaves
    from repro_torch.sharding.rules import merged_rules
    from repro_torch.train import AdamWConfig, make_train_step, zero_shardings
    cfg = tp_f32_cfg()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, ShardCtx(mesh, merged_rules(mesh)), device="meta")
    psh, gsh = zero_shardings(model, mesh)
    state = zero_state(zero_draw(cfg, device, SEED + 186, psh), model, gsh,
                       torch.float32, device)
    step = make_train_step(model, AdamWConfig(lr=TRAIN_CPU_LR), gsh,
                           param_shardings=psh, device=device)
    batch = train_batch(cfg, 1, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, SEED + 187)
    loss, grads = step.grads(state, batch)
    del state
    one = torch.load(os.path.join(out_dir, "tp_f32.pt"), mmap=True)
    paths, sums = [], []
    for (path, g), (_, s) in zip(leaves(grads), leaves(gsh)):
        k = "/".join(map(str, path))
        paths.append(k)
        if not owns(s):
            sums.append([0.0] * 5)
            continue
        a = one["grads"][k]
        want = a[tuple(slice(lo, hi) for lo, hi in s.bounds(a.shape))]
        sums.append(zero_sums(g, want.to(device)))
    total = world_rows(sums, torch.float64).sum(0)
    worst = max((zero_gaps(total[i].tolist())[0], p)
                for i, p in enumerate(paths))
    res = dict(loss=float(loss), one_loss=one["loss"], worst=worst,
               seconds=time.perf_counter() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del grads, one
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_context_parallel(mesh, device) -> list[dict]:
    """(d) ``chunked_attention`` at TP_CP's shapes on ``mesh`` (its model
    axis does not divide the 6 heads) against one device on the same
    card tensors, each between CUDA events."""
    from repro_torch.models import ShardCtx, attention
    from repro_torch.sharding import layout
    from repro_torch.sharding.rules import merged_rules
    ctx = ShardCtx(mesh, merged_rules(mesh))
    out = []
    for j, (shape, dtype, cq, ck) in enumerate(TP_CP):
        gen = torch.Generator(device).manual_seed(SEED + 199 + j)
        q, k, v = (torch.randn(shape, generator=gen, device=device,
                               dtype=torch.float32).to(dtype)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(shape[-1]) if j else 0.25
        kw = dict(scale=scale, q_chunk=cq, k_chunk=ck)
        times = {}
        for tag, c in (("one", None), ("cp", ctx)) * 2:   # warm, then timed
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            with layout.record_traffic() as sent:
                ev[0].record()
                res = (attention.chunked_attention(q, k, v, **kw)
                       if c is None else
                       attention.chunked_attention(q, k, v, ctx=c, **kw))
                ev[1].record()
                torch.cuda.synchronize()
            times[tag] = (res, ev[0].elapsed_time(ev[1]), len(sent.calls))
        err = (times["cp"][0].double() - times["one"][0].double()).abs()
        out.append(dict(shape=list(shape), dtype=str(dtype), q_chunk=min(
            cq, shape[1] // ctx.model_size), max_err=float(err.max()),
            median_err=float(err.median()), cp_ms=times["cp"][1],
            one_ms=times["one"][1], collectives=times["cp"][2]))
    return out


def tp_rank(rank: int, out_dir: str, device: str = "cuda") -> None:
    """Phase 16 on one rank of the gloo world: (a)-(g); writes
    ``tp_rank<rank>.json``."""
    from repro_torch.launch.mesh import make_debug_mesh
    dev = torch.device(device)
    if dev.type == "cuda":
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        torch.cuda.set_device(0)
    meshes = {s: make_debug_mesh(*s, device_type=dev.type)
              for s in {s for _, s in TP_ARCHS} | {(1, 4)}}
    res = dict(rank=rank, coordinate={f"{a}x{b}": list(m.get_coordinate())
                                      for (a, b), m in meshes.items()})
    for i, (name, shape) in enumerate(TP_ARCHS):
        one = torch.load(os.path.join(out_dir, f"tp_one_{i}.pt"))
        res[name] = tp_serve(rank, i, name, meshes[shape], dev, one)
        del one
        gc.collect()
    res["train"] = {name: tp_train(rank, name, meshes[shape], steps, dev)
                    for name, shape, steps in TP_TRAIN}
    res["f32"] = tp_f32(rank, meshes[(2, 2)], dev, out_dir)
    res["cp"] = tp_context_parallel(meshes[(1, 4)], dev)
    with open(os.path.join(out_dir, f"tp_rank{rank}.json"), "w") as f:
        json.dump(res, f)


def gb(b: dict) -> str:
    return ", ".join(f"{a} {v / 1e9:.4f} GB" for a, v in sorted(b.items()))


def tp_path(card: str) -> dict:
    """Phase 16: tensor-parallel compute in a gloo world of four on the
    card; -> the results, with the ``fused_cotm`` launches of (e)."""
    import tempfile
    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        spawn(tp_one_device, 1, tmp, init_method=f"file://{tmp}/store1")
        ones = [torch.load(os.path.join(tmp, f"tp_one_{i}.pt"))
                for i in range(len(TP_ARCHS))]
        t1 = time.perf_counter()
        spawn(tp_rank, TP_WORLD, tmp, "cuda",
              init_method=f"file://{tmp}/store4")
        world_s = time.perf_counter() - t1
        ranks = [json.load(open(os.path.join(tmp, f"tp_rank{r}.json")))
                 for r in range(TP_WORLD)]
    r0 = ranks[0]
    for i, (name, shape) in enumerate(TP_ARCHS):
        cfg, one, a = tp_cfg(name), ones[i], r0[name]
        tag = TP_TAGS[i]
        print(f"phase 16 ({tag}) {name} x {cfg.n_layers} layers at full "
              f"width (d {cfg.d_model}, heads {cfg.n_heads}/"
              f"{cfg.n_kv_heads}, V {cfg.vocab}), {a['full']:,} "
              f"parameters, on {shape[0]} x {shape[1]}: prefill "
              f"{LM_BATCH} x {LM_PROMPT}"
              + (f" + {TP_IMAGE} patch embeddings" if cfg.rope_style
                 == "mrope" else "")
              + f", {LM_DECODE} decode steps fed the one-device tokens "
              f"(one device: {one['seconds']:.1f} s, peak "
              f"{one['peak_gib']:.2f} GiB); {card}")
        e, l = a["e2e"], a["layers"]
        print(f"  rank 0's gates: layers teacher-forced vs one device "
              f"max {l['max']:.3e} (bounds {LM_LAYER_BOUNDS}), end to end "
              f"median {e['median']:.3e} p99 {e['p99']:.3e} max "
              f"{e['max']:.3e} (bounds {TP_E2E_BOUNDS}); greedy tokens of "
              f"the TP logits equal one device's at "
              f"{a['greedy_equal']:.4f} of {LM_BATCH * LM_DECODE}: "
              + str(a["greedy"][0][:LM_DECODE]))
        for r in ranks:
            x = r[name]
            print(f"  rank {r['rank']}: holds {x['mine']:,} of "
                  f"{x['full']:,} parameters "
                  f"({100 * x['mine'] / x['full']:.1f}%), peak "
                  f"{x['peak_gib']:.2f} GiB; prefill {x['prefill_ms']:.2f}"
                  f" ms CUDA events / {x['prefill_wall_ms']:.2f} ms host "
                  f"wall, sent {gb(x['prefill_bytes'])}; decode step "
                  f"median {statistics.median(x['step_ms']):.3f} ms / "
                  f"{statistics.median(x['step_wall_ms']):.3f} ms host, "
                  f"sent {gb(x['step_bytes'][-1])} a step")
            if x["mine"] >= x["full"]:
                fail(f"phase 16 ({tag}): rank {r['rank']} holds every "
                     f"parameter")
        if cfg.moe is not None:
            auxes = [r[name]["aux"] for r in ranks]
            print(f"  aux loss (per data shard, averaged over the data "
                  f"axis) {auxes[0]:.6f} on every rank vs one device's "
                  f"mean of its two row halves {one['aux']:.6f}")
            if len(set(auxes)) != 1 or not abs(
                    auxes[0] - one["aux"]) <= 1e-2 * abs(one["aux"]):
                fail(f"phase 16 ({tag}): aux {auxes} vs {one['aux']}")
    for n, _ in TP_ARCHS:
        if len({json.dumps(r[n]["greedy"]) for r in ranks}) != 1:
            fail(f"phase 16 {n}: ranks disagree on the greedy tokens")

    for name, shape, steps in TP_TRAIN:
        t, tag = r0["train"][name], TP_TAGS[[n for n, _ in
                                             TP_ARCHS].index(name)]
        print(f"phase 16 ({tag}) training: {name} x "
              f"{tp_cfg(name).n_layers} layers, {steps} ZeRO + TP "
              f"step(s) of {ZERO_ACCUM} x {ZERO_BATCH} x {ZERO_SEQ} on "
              f"{shape[0]} x {shape[1]}: losses "
              + ", ".join(f"{x:.4f}" for x in t["losses"]) + f"; {card}")
        for r in ranks:
            x = r["train"][name]
            print(f"  rank {r['rank']}: holds {x['mine']:,} of "
                  f"{x['full']:,} state elements "
                  f"({100 * x['mine'] / x['full']:.1f}%), peak "
                  f"{x['peak_gib']:.2f} GiB, steps "
                  + ", ".join(f"{w:.0f}" for w in x["wall_ms"])
                  + " ms host wall, sent " + "; ".join(gb(b) for b in
                                                      x["bytes"])
                  + "; replicated shards: " + "; ".join(
                      f"{s} leaves, {p} pairs, {d} differ"
                      for s, p, d in x["replicas"]))
        losses = [r["train"][name]["losses"] for r in ranks]
        if any(x != losses[0] for x in losses) or not all(
                math.isfinite(x) for x in losses[0]) or (
                steps > 1 and not losses[0][-1] < losses[0][0]):
            fail(f"phase 16 ({tag}): losses {losses}")
        if any(d for r in ranks for _, _, d in r["train"][name]["replicas"]):
            fail(f"phase 16 ({tag}): replicated shards differ across ranks")
    f = r0["f32"]
    rel_loss = abs(f["loss"] - f["one_loss"]) / abs(f["one_loss"])
    print(f"phase 16 (f) f32: {TP_F32_ARCH} x {ZERO_F32_LAYERS} layer, "
          f"f32, ZeRO-3, one ZeRO + TP step of 1 x {TRAIN_CPU_BATCH} x "
          f"{TRAIN_CPU_SEQ} on 2 x 2 vs one device: loss {f['loss']:.6f} "
          f"vs {f['one_loss']:.6f} (rel {rel_loss:.2e}, bound "
          f"{TRAIN_CPU_LOSS_RTOL}), worst gradient rel Frobenius "
          f"{f['worst'][0]:.3e} at {f['worst'][1]} (bound "
          f"{TRAIN_CPU_GRAD_FROB}); {f['seconds']:.1f} s, peak "
          f"{f['peak_gib']:.2f} GiB a rank")
    if not (rel_loss <= TRAIN_CPU_LOSS_RTOL
            and f["worst"][0] <= TRAIN_CPU_GRAD_FROB):
        fail(f"phase 16 (f) f32: {f}")
    crossed = [(r["rank"], k, x["crossed"]) for r in ranks
               for k, x in [(n, r[n]) for n, _ in TP_ARCHS]
               + list(r["train"].items()) if x["crossed"]]
    print(f"phase 16: collectives over the model axis with a weight's "
          f"shape (whole or a block) in every prefill, decode step and "
          f"train step of (a)-(c), (f), (g) on every rank: {len(crossed)}")
    if crossed:
        fail(f"phase 16: a weight crossed the model axis: {crossed[:4]}")

    for c in r0["cp"]:
        print(f"phase 16 (d) chunked_attention {tuple(c['shape'])} "
              f"{c['dtype']} context parallel on 1 x 4 (q_chunk "
              f"{c['q_chunk']}, one all-gather: {c['collectives']} "
              f"collective) vs one device: max abs err {c['max_err']:.3e}, "
              f"median {c['median_err']:.3e} (bound {TP_CP_BOUND}); "
              f"{c['cp_ms']:.3f} ms a rank vs {c['one_ms']:.3f} ms one "
              f"device, CUDA events; {TP_HEADS_NOTE}")
        if not c["max_err"] < TP_CP_BOUND or c["collectives"] != 1:
            fail(f"phase 16 (d): {c}")
    heads = {}                  # K -> (launches, max abs err)
    for name in TP_HEADS:
        h = r0[name]["head"]
        print(f"phase 16 (e) TM head on {name}'s pooled TP prefill states "
              f"{tuple(h['shape'])}, K = {h['K']}: fused_cotm launched "
              f"{h['launches']} time(s) in the window, scores bitwise equal "
              f"to fused_cotm_ref ({h['nonzero']} nonzero of {h['n']})")
        if h["launches"] == 0:
            fail(f"phase 16 (e): fused_cotm was never launched on {name}'s "
                 f"TP path")
        n, e = heads.get(h["K"], (0, 0.0))
        heads[h["K"]] = (n + h["launches"], max(e, h["err"]))
    wall = time.perf_counter() - t0
    print(f"phase 16: tensor-parallel path done in {wall:.1f} s (the world "
          f"{world_s:.1f} s); {card}")
    return dict(ranks=ranks, seconds=wall, heads=heads)


# -- phase 17 --------------------------------------------------------------

# The dry run (repro_torch.launch.dryrun.measure) of the cells the card
# runs, at their configs, depths and batches, in a process of its own
# started at the script's start (the fake process group is
# process-global; CUDA_VISIBLE_DEVICES is empty there, so it cannot touch
# the card): (key, phase, architecture, mesh, kind).
DRY_CELLS = (("14f", "14 (f)", TRAIN_ARCH, None, "train"),
             ("16a/prefill", "16 (a)", "llama3-8b", (2, 2), "prefill"),
             ("16a/train", "16 (a)", "llama3-8b", (2, 2), "train"),
             ("16g/prefill", "16 (g)", "zamba2-7b", (1, 4), "prefill"),
             ("16g/train", "16 (g)", "zamba2-7b", (1, 4), "train"))


def dry_cells(out_path: str) -> None:
    """Phase 17's dry runs: each of DRY_CELLS' records -> ``out_path``
    (JSON).  Run by ``dry_start``, in a process of its own."""
    import warnings
    warnings.filterwarnings("ignore", category=FutureWarning)
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import measure
    from repro_torch.models.config import ShapeSpec
    recs = {}
    for key, _, name, mesh, kind in DRY_CELLS:
        if key == "14f":
            cfg = dataclasses.replace(get_config(name), n_layers=TRAIN_LAYERS)
            shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_ACCUM * TRAIN_BATCH,
                              "train", accum=TRAIN_ACCUM)
        elif kind == "train":
            cfg = tp_cfg(name)
            shape = ShapeSpec("train", ZERO_SEQ, ZERO_ACCUM * ZERO_BATCH,
                              "train", accum=ZERO_ACCUM)
        else:
            cfg = tp_cfg(name)
            shape = ShapeSpec("prefill", LM_PROMPT, LM_BATCH, "prefill")
        recs[key] = measure(cfg, shape, mesh, max_len=LM_PROMPT + LM_DECODE)
    with open(out_path, "w") as f:
        json.dump(recs, f)


def dry_start(out_dir: str) -> subprocess.Popen:
    """``dry_cells`` in a process of its own that cannot see the card,
    started now; stopped at exit if it is still running."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.dry_cells("
         f"{os.path.join(out_dir, 'dry.json')!r})"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def dry_path(proc: subprocess.Popen, out_dir: str, llama: dict,
             tp: dict, card: str) -> dict:
    """Phase 17: the dry run's records against what the card's ranks held
    and sent (module docstring): ``llama`` is phase 14 (a)'s result,
    ``tp`` phase 16's."""
    from repro_torch.launch.dryrun import HBM_BYTES, HBM_NAME
    t0 = time.perf_counter()
    log, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        fail(f"phase 17: the dry run failed:\n{log[-3000:]}")
    with open(os.path.join(out_dir, "dry.json")) as f:
        recs = json.load(f)
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"phase 17: the dry run of {len(DRY_CELLS)} cells on meta in "
          f"fake worlds (a process of its own, started at the script's "
          f"start: {sum(r['lower_s'] for r in recs.values()):.1f} s of "
          f"runs); {torch.cuda.get_device_name(0)} total_memory {total} B "
          f"(dryrun.HBM_BYTES {HBM_BYTES} B for {HBM_NAME}); {card}")
    ranks = tp["ranks"]
    for key, phase, name, mesh, kind in DRY_CELLS:
        rec = recs[key]
        if key == "14f":
            held = [(0, llama["state_bytes"], llama["sent"],
                     llama["steps_peak"])]
        elif kind == "prefill":
            held = [(r["rank"], r[name]["mine_bytes"],
                     [r[name]["prefill_bytes"]], r[name]["prefill_peak"])
                    for r in ranks]
        else:
            x = [(r["rank"], r["train"][name]) for r in ranks]
            held = [(i, t["state_bytes"], t["bytes"], t["steps_peak"])
                    for i, t in x]
        m = rec["memory"]
        want = m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
        depth = TRAIN_LAYERS if key == "14f" else tp_cfg(name).n_layers
        print(f"  {phase} {name} x {depth} {kind} (run at depths "
              f"{', '.join(map(str, rec['depth_run']))}) on "
              f"{'one device' if mesh is None else f'{mesh[0]} x {mesh[1]}'}"
              f": state {m['state_size_in_bytes']:,} B a rank (the ranks "
              f"held " + ", ".join(f"{b:,}" for _, b, _, _ in held)
              + f"); sent by axis {gb(rec['collectives']['by_axis']) or '-'}"
              f" a {'step' if kind == 'train' else 'prefill'} (the ranks' "
              f"record_traffic: " + "; ".join(
                  gb(s[0]) or "-" for _, _, s, _ in held) + ")")
        print(f"    predicted peak {want / 2**30:.3f} GiB (arguments "
              f"{m['argument_size_in_bytes'] / 2**30:.3f} + temp "
              f"{m['temp_size_in_bytes'] / 2**30:.3f}) vs "
              f"max_memory_allocated " + ", ".join(
                  f"{p / 2**30:.3f}" for _, _, _, p in held)
              + " GiB: ratio " + ", ".join(
                  f"{p / want:.3f}" for _, _, _, p in held)
              + f"; {rec['cost']['flops']:.4e} FLOPs, "
              f"{rec['cost']['bytes accessed']:.4e} op bytes a rank")
        for r, b, sent, _ in held:
            if b != m["state_size_in_bytes"]:
                fail(f"phase 17 {key}: rank {r} held {b} B of state, the "
                     f"dry run {m['state_size_in_bytes']}")
            if any(s != rec["collectives"]["by_axis"] for s in sent):
                fail(f"phase 17 {key}: rank {r} sent {sent}, the dry run "
                     f"{rec['collectives']['by_axis']}")
    wall = time.perf_counter() - t0
    print(f"phase 17: dry run held to the card in {wall:.1f} s; {card}")
    return dict(records=recs, seconds=wall)


# -- phase 18 --------------------------------------------------------------

# The paper's experiments (``repro_torch.paper``): Tables 4 and 6 and Fig.
# 13 on phase 5's trained parameters (the paper's MNIST CoTM config,
# passed in, not retrained), Table 5 on all seven datasets at the
# reference's sizes, Figs. 7-8 at the reference's c2c(60) / d2d(100).
PAPER_TABLE5_TRAIN, PAPER_TABLE5_EPOCHS = 2000, 6
PAPER_C2C_CYCLES, PAPER_D2D_DEVICES = 60, 100
PAPER_KERNELS = ("fused_impact_f32", "fused_impact_metered_f32",
                 "crossbar_mvm_f32")
# The Table 5 system whose operands hold fused_impact to its plain
# version: two 512-column clause tiles.
PAPER_CHECK_DATASET = "cifar2"


def paper_path(model: tuple, device, card: str) -> dict:
    """Phase 18: the sections of ``repro_torch.paper`` on the card between
    one reset and one read of the launch counts (Table 4's gates raise
    inside its section), then ``fused_impact`` on the cifar2 system's own
    operands against its plain version: CSA bits (through an identity
    class operand) and argmax exact, scores at RTOL_SCORES.  Returns the
    phase's launch counts and wall."""
    from repro_torch import kernels
    from repro_torch.data.synthetic import table5_dataset
    from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_impact import fused_impact
    from repro_torch.paper import (common, fig7_8_variability,
                                   fig13_tuning_sweep, table4_energy,
                                   table5_datasets, table6_comparison)
    params, cfg = model
    t0 = time.perf_counter()
    trained = common.trained_mnist_cotm(device=device, params=params)
    if trained.cfg != cfg:
        fail(f"phase 18: phase 5 trained at {cfg}, the paper's sections "
             f"run at {trained.cfg}")
    systems: dict = {}
    sections = (
        ("table4", lambda: table4_energy.main(device=device,
                                              trained=trained)),
        ("table6", lambda: table6_comparison.main(device=device,
                                                  trained=trained)),
        ("fig13", lambda: fig13_tuning_sweep.main(device=device,
                                                  trained=trained)),
        ("table5", lambda: table5_datasets.main(
            device=device, n_train=PAPER_TABLE5_TRAIN,
            epochs=PAPER_TABLE5_EPOCHS, systems=systems)),
        ("fig7_8", lambda: fig7_8_variability.main(
            device=device, cycles=PAPER_C2C_CYCLES,
            n_devices=PAPER_D2D_DEVICES)))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    walls, rows = {}, {}
    for name, run in sections:
        t = time.perf_counter()
        rows.update((r.name, r) for r in run())
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
    launches = kernels.launch_counts()
    for sym in PAPER_KERNELS:
        if launches[sym] == 0:
            fail(f"phase 18: {sym} was never launched by the paper's "
                 f"sections")
    t4 = {k: rows[f"table4/{k}"].values["ours"] for k in (
        "clause_pJ_per_datapoint", "clause_pJ_per_datapoint_fused",
        "class_pJ_per_datapoint", "class_pJ_per_datapoint_fused",
        "tops_per_w", "tops_per_w_fused")}
    print(f"phase 18: Table 4's gates held (fused vs staged: clause "
          f"{t4['clause_pJ_per_datapoint_fused']!r} / "
          f"{t4['clause_pJ_per_datapoint']!r} pJ, class "
          f"{t4['class_pJ_per_datapoint_fused']!r} / "
          f"{t4['class_pJ_per_datapoint']!r} pJ, TOPS/W "
          f"{t4['tops_per_w_fused']!r} / {t4['tops_per_w']!r}); sections' "
          f"walls " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
          + f"; launches {', '.join(f'{s} {launches[s]}' for s in PAPER_KERNELS)}")

    # fused_impact on the trained two-column-tile system's operands.
    system = systems[PAPER_CHECK_DATASET]
    xt, _, _ = table5_dataset(PAPER_CHECK_DATASET, 400, seed=7)
    lits = table5_datasets.literals(xt, device).to(torch.int8)
    ci, ne, cls = system.clause_i, system._nonempty_eff(), system.class_i
    R, C, tr, tc = ci.shape
    S, sr, _ = cls.shape
    got = fused_impact(lits, ci, ne, cls, thresh=TH)
    want = ref.fused_impact_ref(lits, ci, ne, cls, thresh=TH)
    exact(f"phase 18 {PAPER_CHECK_DATASET}: fused_impact argmax",
          got.argmax(-1), want.argmax(-1))
    err = allclose(f"phase 18 {PAPER_CHECK_DATASET}: fused_impact scores",
                   got, want, RTOL_SCORES)
    eye = identity_class(S, sr, C * tc, device)
    bits = fused_impact(lits, ci, ne, eye, thresh=TH) > 0.5
    want_bits, i_col = ref.impact_clause_bits_ref(lits, ci, ne, thresh=TH)
    if not bool(want_bits.any()):
        fail(f"phase 18 {PAPER_CHECK_DATASET}: no clause fired on the "
             f"test literals, so the CSA bits check holds nothing")
    csa_bits_exact(f"phase 18 {PAPER_CHECK_DATASET}: fused_impact CSA bits",
                   bits, want_bits, i_col, TH)
    wall = time.perf_counter() - t0
    print(f"phase 18: fused_impact on the {PAPER_CHECK_DATASET} system "
          f"((R, C, tr, tc) = {(R, C, tr, tc)}, {tuple(lits.shape)} "
          f"literals): CSA bits ({int(want_bits.sum())} fired) and argmax "
          f"exact, scores max abs err {err:.3e}; phase 18 done in "
          f"{wall:.1f} s; {card}")
    return dict(launches=launches, seconds=wall, max_abs_err=err)


# -- phase 19 --------------------------------------------------------------

# The benchmark's dsv2lite.docs-bulk cell: 8 documents a batch, each batch
# right-padded to these lengths (perfbench/traffic/docs-bulk.json), and
# DeepSeek-V2-Lite's 16 heads.
FLASH_BATCH, FLASH_HEADS = 8, 16
FLASH_LENGTHS = (512, 768, 896, 1024, 1280, 1536, 2048, 4096)
# tests/test_torch_flash_attention.py's card bounds (relative L2, largest
# difference) at f32 output: the order of summation and one bf16 ulp of a
# probability (exp2f against torch.exp).
FLASH_REL_L2, FLASH_MAX_ABS = 2e-4, 4e-3
BF16_PEAK_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12


def flash_main_path(device) -> int:
    """Phase 19 (a): DeepSeek-V2-Lite whole through ``model.hidden`` at
    the cell's largest batch; the launches and calls of MLA's prefill
    attention counted from zero.  Returns ``flash_mla_prefill``'s
    launches."""
    from repro_torch import kernels, tracing
    from repro_torch.configs.deepseek_v2_lite_16b import published
    from repro_torch.models import build
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = published()
    model = build(cfg, device=device).init(
        torch.Generator(device).manual_seed(SEED + 19))
    S = FLASH_LENGTHS[-1]
    gen = torch.Generator(device).manual_seed(SEED + 190)
    tokens = torch.randint(0, cfg.vocab, (FLASH_BATCH, S), device=device,
                           generator=gen)
    positions = torch.arange(S, device=device).expand(FLASH_BATCH, S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    tracing.reset()
    tracing.enable()
    try:
        with torch.no_grad():
            x, _ = model.hidden(tokens, positions)
        torch.cuda.synchronize()
        tracing.flush()
        calls = tracing.totals()
    finally:
        tracing.disable()
        tracing.reset()
    launches = kernels.launch_counts()["flash_mla_prefill"]
    count = {n: calls.get(n, {"count": 0})["count"]
             for n in ("attn.kernel_calls", "attn.plain_calls")}
    if not torch.isfinite(x).all():
        fail("phase 19 (a): DeepSeek-V2-Lite hidden states not finite")
    if (launches, count["attn.kernel_calls"], count["attn.plain_calls"]) \
            != (cfg.n_layers, cfg.n_layers, 0):
        fail(f"phase 19 (a): MLA prefill on the main path launched "
             f"flash_mla_prefill {launches} times, attn.kernel_calls "
             f"{count['attn.kernel_calls']}, attn.plain_calls "
             f"{count['attn.plain_calls']}; want {cfg.n_layers}, "
             f"{cfg.n_layers}, 0 (one a layer)")
    print(f"phase 19 (a) DeepSeek-V2-Lite, {cfg.n_layers} layers, "
          f"{model.n_params():,} parameters, hidden at ({FLASH_BATCH}, {S}): "
          f"flash_mla_prefill launched {launches} times, attn.kernel_calls "
          f"{count['attn.kernel_calls']}, attn.plain_calls "
          f"{count['attn.plain_calls']}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del model, x
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def flash_path(device, card: str) -> dict:
    """Phase 19: (a) the main path's launches (``flash_main_path``); (b)
    ``flash_prefill`` against its plain version at the cell's batch
    shapes, bitwise from launch to launch, and timed beside its bound, its
    plain version and one PyTorch call.  Returns the kernel table's row
    (at the largest shape) and the rows a shape."""
    from repro_torch.kernels import flash_attention as flash
    launches = flash_main_path(device)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = 1.0 / math.sqrt(flash.D_NOPE + flash.D_ROPE)
    B, H = FLASH_BATCH, FLASH_HEADS
    t0 = time.perf_counter()
    shapes, worst = [], 0.0
    for S in FLASH_LENGTHS:
        g = torch.Generator(device=device).manual_seed(S)
        draw = lambda *shape: torch.randn(*shape, device=device,
                                          generator=g).bfloat16()
        q, kn, kr, v = (draw(B, S, H, 192), draw(B, S, H, 128),
                        draw(B, S, 64), draw(B, S, H, 128))
        args = ((q[..., :128], q[..., 128:].contiguous()), (kn, kr), v)
        got = flash.flash_prefill(*args, scale=scale, out_dtype=torch.float32)
        again = flash.flash_prefill(*args, scale=scale,
                                    out_dtype=torch.float32)
        want = flash.flash_prefill_ref(*args, scale=scale,
                                       out_dtype=torch.float32)
        torch.cuda.synchronize()
        exact(f"phase 19 S={S}: flash_prefill run to run", again, got)
        rel = ((got - want).norm() / want.norm()).item()
        err = (got - want).abs().max().item()
        if not (rel < FLASH_REL_L2 and err < FLASH_MAX_ABS):
            fail(f"phase 19 S={S}: flash_prefill against its plain version "
                 f"rel L2 {rel:.3e} (bound {FLASH_REL_L2}), max abs "
                 f"{err:.3e} (bound {FLASH_MAX_ABS})")
        worst = max(worst, err)
        kf = torch.cat([kn, kr[:, :, None, :].expand(B, S, H, 64)], -1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kf, v))
        ms = cuda_ms(lambda: flash.flash_prefill(*args, scale=scale))
        plain = cuda_ms(lambda: flash.flash_prefill_ref(*args, scale=scale),
                        iters=3)
        lib = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, scale=scale))
        flops, moved = flash.causal_work(S, H, B)
        by_ops, by_bytes = flops / BF16_PEAK_FLOPS, moved / HBM_BYTES_PER_S
        bound = max(by_ops, by_bytes) * 1e3
        bound_by = "ops" if by_ops >= by_bytes else "bytes"
        shapes.append(dict(S=S, ms=ms, bound_ms=bound, bound_by=bound_by,
                           plain_ms=plain, library_ms=lib, rel_l2=rel,
                           max_abs_err=err))
        print(f"phase 19 (b) (B, S, H) = ({B}, {S}, {H}): kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s, {moved / ms / 1e6:.1f} "
              f"GB/s; {bound / ms:.1%} of its bound {bound:.4f} ms by "
              f"{bound_by}), plain {plain:.2f} ms, library {lib:.4f} ms; "
              f"against plain rel L2 {rel:.3e}, max abs {err:.3e}",
              flush=True)
    top = shapes[-1]
    print(f"phase 19: flash_prefill done in {time.perf_counter() - t0:.1f} "
          f"s; {card}")
    row = dict(name="flash_prefill (MLA)", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_mla.cu",
               replaces="none (the reference's attention is plain jnp)",
               launches=launches, max_abs_err=worst, ms=top["ms"],
               plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
               bound_by=top["bound_by"], library_ms=top["library_ms"])
    return dict(row=row, shapes=shapes)


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
    import tempfile
    dry_dir = tempfile.mkdtemp(prefix="chip_smoke_dry")
    dry = dry_start(dry_dir)

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
    off = check_numerics(device)
    print(f"phase build: sqrt_rn / rsqrt_rn on the card equal the f64 route "
          f"on {NUMERICS_DRAWS} f32 draws; the card's own f32 "
          + ", ".join(f"{k} differs on {n}" for k, n in off.items()))
    for source in ("crossbar_mvm.cu", "fused_impact.cu", "ta_feedback.cu",
                   "digital_cotm.cu", "flash_mla.cu"):
        for line in kernel_resources(source):
            print(f"  {source} {line}")

    t0 = time.perf_counter()
    errs = check_kernels(device)
    errs.update(check_packed_kernels(device))
    for k, v in check_tail_lanes(device).items():
        errs[k] = max(errs[k], v)
    for k, v in check_paired(device).items():
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
    graph_path(served, trained, compressed, coresident, card)
    # The sharded path runs crossbar_mvm (row 3) on every rank's shards.
    mvm_row = next(r for r in rows if r["name"] == "crossbar_mvm")
    mvm_row["launches"] += sharded_path(card)["launches"]
    _, head_row = lm_path(device, card)
    rows.append(head_row)
    _, ssm_row = ssm_path(device, card)
    rows.append(ssm_row)
    llama_train = train_lm_path(device, card)["llama"]
    # Phase 18 reads phase 5's trained model; phase 15's world needs the
    # card to itself: drop what the earlier phases hold.
    paper_model = trained["model"]
    del served, trained, compressed, coresident, _
    zero_path(card)
    tp = tp_path(card)
    for row, name in ((head_row, LM_ARCH), (ssm_row, SSM_ROW_ARCH)):
        n, e = tp["heads"].pop(head_literals(name))
        row["launches"] += n
        row["max_abs_err"] = max(row["max_abs_err"], e)
    if tp["heads"]:
        fail(f"phase 16: head launches at no row's shape: {tp['heads']}")
    dry_path(dry, dry_dir, llama_train, tp, card)
    paper = paper_path(paper_model, device, card)
    for r in rows:
        sym = {"fused_impact": "fused_impact_f32",
               "fused_impact_metered": "fused_impact_metered_f32",
               "crossbar_mvm": "crossbar_mvm_f32"}.get(r["name"])
        if sym is not None:
            r["launches"] += paper["launches"][sym]
        if r["name"] == "fused_impact":
            r["max_abs_err"] = max(r["max_abs_err"], paper["max_abs_err"])
    time_pass1(device)
    time_tail(device)
    rows.append(flash_path(device, card)["row"])
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

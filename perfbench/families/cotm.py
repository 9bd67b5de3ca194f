"""The CoTM family: a Coalesced Tsetlin Machine on IMPACT's Y-Flash
crossbar tiles, served by the port's compiled session to bulk metered
classification.

``deploy`` draws a deployment from the configuration and the seed on the
device, in a few large calls: an include mask at the configuration's
density with every clause nonempty, signed class weights, and
conductances drawn with the frozen Y-Flash constants (included cells in
the HCS, excluded and padding cells in the LCS, the class tile at the
weight targets) and the paper's device-to-device spread.  ``pool`` draws
the traffic's batches in the literal layout ``[bits, ~bits]``, so that
exactly K/2 rows of every datapoint are driven, each datapoint of a
class with about the configuration's share of that class's clauses
firing.  ``Cell`` hands the conductances to the port
(``repro_torch.convert.system_from_arrays``; the port derives the read
currents with its own read model), compiles the session and serves one
batch at a time as a user does: ``infer_step``, the results to the host,
a bill a datapoint in f64 and the batch's ``EnergyReport``.  ``check``
holds the kept batches to the plain reference (``references/cotm.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from perfbench.references import cotm as reference
from perfbench.yardstick import work
from perfbench.yardstick.yflash import (G_HCS_BOOL, G_LCS, G_MAX, G_MIN,
                                        G_RANGE_HI, G_RANGE_LO)

#: The numbers ``check`` reads; a cell compares those its limits name.
CHECKS = ("pred_gap", "clause_bill", "class_bill", "class_stage", "report",
          "report_count")
#: Those of them read once a batch, from its ``EnergyReport``.
BATCH_CHECKS = ("report", "report_count")
#: The host spans of one batch, in order.
SPANS = ("session.infer_step", "results", "billing")


@dataclasses.dataclass
class Deployment:
    """A programmed grid: conductances (S) on the device, and what the
    traffic needs to make clauses fire."""
    clause_g: torch.Tensor   # (R, C, tr, tc)
    nonempty: torch.Tensor   # (C*tc,) bool
    class_g: torch.Tensor    # (S, sr, m)
    pos: torch.Tensor        # (K/2, n) bool: clause needs bit = 1
    neg: torch.Tensor        # (K/2, n) bool: clause needs bit = 0
    home: torch.Tensor       # (n,) the class each clause votes for
    select: torch.Tensor     # (n,) chance a datapoint of its class sets it
    n_literals: int
    n_clauses: int
    n_classes: int


def _spread(mean: float, sd_rel: float, shape, gen) -> torch.Tensor:
    return mean * torch.exp(sd_rel * torch.randn(
        shape, generator=gen, device=gen.device))


def deploy(cfg: dict, gen: torch.Generator) -> Deployment:
    """The deployment of ``cfg`` drawn from ``gen`` on its device."""
    dev = gen.device
    K, n, m = cfg["n_literals"], cfg["n_clauses"], cfg["n_classes"]
    tr, tc, sr = (cfg["max_tile_rows"], cfg["max_tile_cols"],
                  cfg["max_class_rows"])
    a = cfg["assumed"]
    F = K // 2
    R, C, S = -(-K // tr), -(-n // tc), -(-n // sr)
    # Include mask: feature j's positive literal (bit j) or its negation
    # (literal F + j) with the configured density each, never both.
    rho = a["include_density"]
    u = torch.rand((F, n), generator=gen, device=dev)
    pos, neg = u < rho, (u >= rho) & (u < 2 * rho)
    empty = ~(pos | neg).any(dim=0)
    pick = torch.randint(0, F, (n,), generator=gen, device=dev)
    cols = torch.arange(n, device=dev)
    pos[pick, cols] = pos[pick, cols] | empty
    include = torch.cat([pos, neg])                           # (K, n)
    # Clause tile: HCS where included, LCS elsewhere, padding included.
    inc = torch.zeros((R * tr, C * tc), dtype=torch.bool, device=dev)
    inc[:K, :n] = include
    lcs = _spread(a["lcs_s"], a["lcs_sd_rel"], inc.shape, gen)
    lcs = torch.where(lcs >= G_LCS, 2 * G_LCS - lcs, lcs).clamp(min=G_MIN)
    hcs = _spread(a["hcs_s"], a["hcs_sd_rel"], inc.shape, gen)
    hcs = torch.where(hcs <= G_HCS_BOOL, 2 * G_HCS_BOOL - hcs,
                      hcs).clamp(max=G_MAX)
    clause_g = torch.where(inc, hcs, lcs).reshape(R, tr, C, tc)
    clause_g = clause_g.permute(0, 2, 1, 3).contiguous()
    nonempty = torch.zeros(C * tc, dtype=torch.bool, device=dev)
    nonempty[:n] = include.any(dim=0)
    # Signed weights: clause j votes for class j mod m with a weight in
    # [1, w_max] and against the others with one in [w_min, 0].
    w_min, w_max = a["weights"]
    home = cols % m
    r = torch.rand((m, n), generator=gen, device=dev)
    is_home = torch.arange(m, device=dev)[:, None] == home[None, :]
    w = torch.where(is_home, 1 + (r * w_max).floor(),
                    w_min + (r * (1 - w_min)).floor())
    # Class tile: unipolar weights over w_top segments of the analog
    # range, each cell within the fine-tune tolerance of its target.
    w_uni = torch.zeros((S * sr, m), device=dev)
    w_uni[:n] = (w - w.min()).T
    seg = (G_RANGE_HI - G_RANGE_LO) / float(w_uni.max())
    target = G_RANGE_LO + w_uni * seg
    tol = a["class_tol_segments"] * seg
    g = target + a["class_sd_s"] * torch.randn(target.shape, generator=gen,
                                               device=dev)
    g = torch.minimum(torch.maximum(g, target - tol), target + tol)
    class_g = g.clamp(G_MIN, G_MAX).reshape(S, sr, m).contiguous()
    # A clause fires by chance on random bits with probability 2**-includes;
    # a datapoint sets a clause of its class with the chance that makes
    # the class's share fire as configured.
    chance = torch.pow(0.5, include.sum(dim=0).float())
    f = a["fired_share"]
    select = ((f - chance) / (1 - chance)).clamp(0.0, 1.0)
    return Deployment(clause_g.float(), nonempty, class_g.float(), pos, neg,
                      home, select, K, n, m)


def pool(dep: Deployment, traffic: dict,
         gen: torch.Generator) -> list[torch.Tensor]:
    """``traffic["pool_batches"]`` batches of ``traffic["batch"]``
    datapoints, (B, K) int8 literals on the device: a uniform class
    each, the class's clauses set with their ``select`` chance, the bits
    they need set and every other bit a fair coin."""
    dev = gen.device
    B, F = traffic["batch"], dep.n_literals // 2
    pos, neg = dep.pos.T.float(), dep.neg.T.float()          # (n, F)
    out = []
    for _ in range(traffic["pool_batches"]):
        label = torch.randint(0, dep.n_classes, (B,), generator=gen,
                              device=dev)
        u = torch.rand((B, dep.n_clauses), generator=gen, device=dev)
        sel = ((dep.home[None, :] == label[:, None])
               & (u < dep.select[None, :])).float()
        one, zero = (sel @ pos) > 0, (sel @ neg) > 0
        coin = torch.rand((B, F), generator=gen, device=dev) < 0.5
        bits = torch.where(one & ~zero, True, torch.where(zero & ~one, False,
                                                          coin))
        out.append(torch.cat([bits, ~bits], dim=1).to(torch.int8))
    return out


@dataclasses.dataclass
class Output:
    """What one batch hands its user, on the host."""
    predictions: np.ndarray   # (B,) int
    e_clause: np.ndarray      # (B,) J, as the program billed them
    e_class: np.ndarray       # (B,) J
    bills: np.ndarray         # (B,) f64 J, a bill a datapoint
    read_energy_j: float      # the batch report's read energy
    datapoints: int           # the batch report's datapoints


class Cell:
    """One deployment, its pool and the port's session serving it."""

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.device = device
        gen = torch.Generator(device=device).manual_seed(seed)
        self.dep = deploy(cfg, gen)
        self.pool = pool(self.dep, traffic, gen)
        self.batch_size = B = traffic["batch"]
        K, n, m = self.dep.n_literals, self.dep.n_clauses, self.dep.n_classes
        R, C, tr, tc = self.dep.clause_g.shape
        S, sr, _ = self.dep.class_g.shape
        # Rows a datapoint drives (its literals at 0), over the whole pool.
        driven = sum(int((lit == 0).sum()) for lit in self.pool) / (
            len(self.pool) * B)
        flops, moved = work.metered_sweep(B, K, driven,
                                          int(self.dep.nonempty.sum()), m)
        self.flops_per_datapoint = flops / B
        #: The least time of one batch's crossbar work on an H100.
        self.sweep_bound_s = work.bound_s(moved, flops)[0]

        from repro_torch.convert import system_from_arrays
        from repro_torch.impact.runtime import RuntimeSpec
        from repro_torch.impact.yflash import read_current
        host = lambda t: t.cpu().numpy()
        self.system = system_from_arrays(dict(
            clause_g=host(self.dep.clause_g), nonempty=host(self.dep.nonempty),
            class_g=host(self.dep.class_g),
            clause_i=host(read_current(self.dep.clause_g)),
            class_i=host(read_current(self.dep.class_g)),
            n_literals=K, n_clauses=n, n_classes=m,
            # Programmed outside the port: no programming energy to bill.
            program_energy_j=0.0, erase_energy_j=0.0,
            cfg=dict(max_tile_rows=tr, max_tile_cols=tc, max_class_rows=sr),
        ), device=device)
        self.session = self.system.compile(RuntimeSpec(
            metering=traffic["metering"], capacity=B, device=str(device)))
        self.valid = torch.ones(B, dtype=torch.bool, device=device)

    def batch(self, i: int, spans: dict, label=None) -> tuple[Output, float]:
        """Serve pool batch ``i`` -> (its output on the host, seconds from
        issuing it to holding its bills and report).  Adds each span's
        seconds to ``spans``; ``label(name)`` marks it for a profiler."""
        label = label or (lambda name: contextlib.nullcontext())
        t0 = time.perf_counter()
        with label(SPANS[0]):
            res = self.session.infer_step(self.pool[i], self.valid)
        t1 = time.perf_counter()
        with label(SPANS[1]):
            pred = res.predictions.cpu().numpy()
            e_cl = res.e_clause_lanes.cpu().numpy()
            e_cs = res.e_class_lanes.cpu().numpy()
        t2 = time.perf_counter()
        with label(SPANS[2]):
            bills = e_cl.astype(np.float64) + e_cs.astype(np.float64)
            report = self.system.step_report(e_cl, e_cs, len(pred))
        t3 = time.perf_counter()
        for name, dt in zip(SPANS, (t1 - t0, t2 - t1, t3 - t2)):
            spans[name] = spans.get(name, 0.0) + dt
        return Output(pred, e_cl, e_cs, bills, report.read_energy_j,
                      report.datapoints), t3 - t0

    def launches(self) -> int:
        """The port's kernel launches so far (graph replays included)."""
        from repro_torch.kernels._build import launch_counts
        return sum(launch_counts().values())

    def close(self) -> None:
        """Free the program's state: the session, its graphs, the system."""
        self.session = self.system = self.valid = None


def readings(out: Output, ref: tuple[torch.Tensor, ...]) -> dict:
    """The numbers of one batch, each the worst over its datapoints, and
    the per-datapoint numbers (for counting failures).

    ``pred_gap``: by how much the reference's class current of the
    predicted class lies below its best, over the best (0 where they
    agree; a near-tie may flip on rounding alone).  ``clause_bill`` and
    ``class_bill``: each datapoint's billed energy against the
    reference's, over the reference's (the class bill over at least the
    batch's median, since a datapoint that fires nothing bills 0).
    ``class_stage``: the larger of a datapoint's ``pred_gap`` and
    ``class_bill``, the class stage's one number where the prediction's
    gap has no reading of its own that the control separates.
    ``report``: the batch report's read energy against the reference's
    sum, relative; ``report_count``: by how many datapoints the report's
    count misses the batch's."""
    scores, r_cl, r_cs = (t.double().cpu() for t in ref)
    B, m = scores.shape
    pred = torch.from_numpy(np.asarray(out.predictions, np.int64))
    ok = (pred >= 0) & (pred < m)
    best = scores.max(dim=1).values
    got = scores.gather(1, pred.clamp(0, m - 1)[:, None])[:, 0]
    gap = torch.where(best > got, (best - got) / best.clamp(min=1e-30),
                      torch.zeros_like(best))
    gap = torch.where(ok, gap, torch.full_like(gap, float("inf")))
    e_cl = torch.from_numpy(np.asarray(out.e_clause, np.float64))
    e_cs = torch.from_numpy(np.asarray(out.e_class, np.float64))
    cl = (e_cl - r_cl).abs() / r_cl.clamp(min=1e-30)
    cs = (e_cs - r_cs).abs() / torch.maximum(r_cs, r_cs.median()).clamp(
        min=1e-30)
    total = float((r_cl + r_cs).sum())
    each = dict(pred_gap=gap, clause_bill=cl, class_bill=cs,
                class_stage=torch.maximum(gap, cs))
    return dict(per_datapoint=each,
                report=abs(out.read_energy_j - total) / total,
                report_count=float(abs(out.datapoints - B)),
                **{k: float(v.max()) for k, v in each.items()})


def control_output(literals: torch.Tensor, dep: Deployment) -> Output:
    """The control in the program's place: the reference's sweep in TF32,
    handed over as the program hands its results (f32 energies, the
    report's f64 sum)."""
    scores, e_cl, e_cs = reference.sweep(literals, dep.clause_g,
                                         dep.nonempty, dep.class_g,
                                         precision="tf32")
    e_cl, e_cs = e_cl.float().cpu().numpy(), e_cs.float().cpu().numpy()
    bills = e_cl.astype(np.float64) + e_cs.astype(np.float64)
    return Output(scores.argmax(dim=1).cpu().numpy(), e_cl, e_cs, bills,
                  float(bills.sum()), len(bills))


def check(dep: Deployment, pool_: list[torch.Tensor],
          kept: list[tuple[int, Output]], limits: dict) -> tuple[dict, int]:
    """Hold every kept ``(pool index, output)`` to the reference ->
    ({name: worst reading} of every number in ``CHECKS``, datapoints that
    broke the limit of a number the cell compares: one in ``limits``;
    a batch whose report breaks its limit fails every datapoint)."""
    refs = {}
    worst = dict.fromkeys(CHECKS, 0.0)
    failed = 0
    for i, out in kept:
        if i not in refs:
            refs[i] = reference.sweep(pool_[i], dep.clause_g, dep.nonempty,
                                      dep.class_g)
        r = readings(out, refs[i])
        for name in CHECKS:
            if not r[name] <= worst[name]:      # a NaN reading stays NaN
                worst[name] = r[name]
        bad = torch.zeros_like(r["per_datapoint"]["pred_gap"],
                               dtype=torch.bool)
        for name, v in r["per_datapoint"].items():
            if name in limits:
                bad |= ~(v <= limits[name])
        if any(not r[n] <= limits[n] for n in BATCH_CHECKS if n in limits):
            bad[:] = True
        failed += int(bad.sum())
    return worst, failed

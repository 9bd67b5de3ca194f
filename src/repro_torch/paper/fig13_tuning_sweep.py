"""Fig. 13: accuracy and mapping cost against the pulse budget (the port
of ``benchmarks/fig13_tuning_sweep.py``).

Sweeps the max pulse budget of the pre-tune phase, then the fine-tune
phase and the closed-loop adaptive programmer, and records (a) the
classification accuracy on the crossbar system over the first
``n_eval`` (512) test digits and (b) the "cost" = fraction of weight
cells outside their target band.  The paper reaches 95.6% accuracy after
3 pre-tune pulses, 96.2% at 10, and 96.31% after fine-tuning with <= 6
extra pulses.

The clause tile is programmed once (generator seeded 0); every class
tile starts from a generator seeded 1, as the reference's ``key(1)``.
``variability=False`` programs ideal devices (no draws).  The accuracy
reads the clause tile's CSA bits (``ClauseTile.clauses``) and the class
tile's read currents in plain PyTorch; no kernel of the port runs here.
Timings: each row's ``us_per_call`` is the class tile's programming
wall (no warm-up: a programming run is not a session).
"""
from __future__ import annotations

import torch

from ..core import include_mask, to_unipolar
from ..device import resolve_device
from ..impact.tiles import (encode_class_tile, encode_clause_tile,
                            weight_targets)
from ..impact.yflash import G_RANGE_HI, G_RANGE_LO, read_current
from .common import Row, Trained, emit, generator, timed, trained_mnist_cotm

BUDGETS = (1, 2, 3, 5, 10)
MAX_PULSES = 96         # the fine-tune and adaptive programmers' budget


def main(*, device=None, trained: Trained | None = None,
         n_eval: int = 512, variability: bool = True) -> list[Row]:
    dev = resolve_device(device)
    cfg, params, lits, labels, sw_acc = (
        trained if trained is not None else trained_mnist_cotm(device=dev))
    include = include_mask(params.ta_state, cfg.n_states)
    clause_tile, _ = encode_clause_tile(include, generator(dev, 0),
                                        variability=variability)
    w_uni, _ = to_unipolar(params.weights)
    w_t = w_uni.T
    w_max = int(w_uni.max())
    target = weight_targets(w_t, w_max)
    seg = (G_RANGE_HI - G_RANGE_LO) / max(w_max, 1)
    clauses = clause_tile.clauses(lits[:n_eval]).to(torch.float32)
    want = labels[:n_eval]

    def accuracy(class_g: torch.Tensor) -> float:
        scores = clauses @ read_current(class_g)
        return float((torch.argmax(scores, -1) == want).double().mean())

    def cost(g: torch.Tensor, segments: float) -> float:
        return float(((g - target).abs() > segments * seg).double().mean())

    def program(**kw):
        return timed(dev, encode_class_tile, w_t, generator(dev, 1),
                     variability=variability, **kw)

    rows = []
    for budget in BUDGETS:
        (tile, _), us = program(finetune=False, max_pulses=budget)
        acc, c = accuracy(tile.g), cost(tile.g, 20)
        rows.append(emit(f"fig13/pretune_budget_{budget}", us,
                         f"acc={acc:.3f};cost={c:.3f};paper_acc_3p=0.956;"
                         "paper_acc_10p=0.962", acc=acc, cost=c))

    (tile, stats), us = program(finetune=True, max_pulses=MAX_PULSES)
    acc, c = accuracy(tile.g), cost(tile.g, 5)
    fine_pulses = float((stats["finetune_prog"] + stats["finetune_erase"])
                        .double().mean())
    rows.append(emit("fig13/finetuned", us,
                     f"acc={acc:.3f};cost_5seg={c:.3f};"
                     f"mean_finetune_pulses={fine_pulses:.1f};"
                     f"paper_acc=0.9631;sw_acc={sw_acc:.3f}",
                     acc=acc, cost_5seg=c, mean_finetune_pulses=fine_pulses))

    # Beyond the paper: the closed-loop width-selecting programmer.
    (tile, stats), us = program(adaptive=True, max_pulses=MAX_PULSES)
    acc = accuracy(tile.g)
    pulses = float((stats["pretune_prog"] + stats["pretune_erase"])
                   .double().mean())
    err = float((tile.g - target).abs().double().mean() / seg)
    rows.append(emit("fig13/adaptive_controller_beyond_paper", us,
                     f"acc={acc:.3f};mean_pulses={pulses:.1f};"
                     f"mean_err_segments={err:.2f};sw_acc={sw_acc:.3f}",
                     acc=acc, mean_pulses=pulses, mean_err_segments=err))
    return rows


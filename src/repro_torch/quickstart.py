"""Quickstart: the paper's pipeline end to end on the PyTorch/CUDA port.

1. generate a synthetic MNIST-like dataset and booleanize it;
2. train a Coalesced Tsetlin Machine (500 clauses, 10 classes);
3. map the trained TAs + weights onto Y-Flash crossbar tiles (Boolean
   encode + two-phase analog tuning, full C2C/D2D variability);
4. compile the programmed system into a ``metering="fused"`` session and
   run in-memory inference with the paper's Table-4 energy report;
5. cross-check the digital CoTM kernels (``fused_cotm``, and
   ``class_sum`` over ``clause_eval``) against the software CoTM.

Run (on the card, or ``--device cpu`` with the kernels' plain versions):

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
        [--epochs 8] [--clauses 500] [--train 8000] [--test 1000]
"""
from __future__ import annotations

import argparse
import time

import torch

from .core import CoTMConfig, CoTMParams, booleanize, include_mask, predict
from .core.train import train_epochs
from .data.synthetic import digits
from .device import resolve_device
from .impact import RuntimeSpec, build_system
from .kernels import backends

N_LITERALS, N_CLASSES = 1568, 10


def digit_data(n: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` jittered synthetic digits -> (literals (n, 1568) bool, labels
    (n,) int64) on ``device``."""
    x, y = digits(n, seed=seed, jitter=2)
    return (booleanize(torch.from_numpy(x)).to(device),
            torch.from_numpy(y).to(device=device, dtype=torch.int64))


def paper_config(n_clauses: int = 500) -> CoTMConfig:
    """The quickstart's CoTM: K = 1568 literals, 10 classes, N = 128
    states, T = 96, s = 8."""
    return CoTMConfig(n_literals=N_LITERALS, n_clauses=n_clauses,
                      n_classes=N_CLASSES, n_states=128, threshold=96,
                      specificity=8.0)


def accuracy(params: CoTMParams, cfg: CoTMConfig, lits: torch.Tensor,
             labels: torch.Tensor) -> float:
    """Software (digital CoTM) accuracy."""
    return float((predict(params, lits, cfg) == labels).double().mean())


def train(params: CoTMParams, cfg: CoTMConfig, lits: torch.Tensor,
          labels: torch.Tensor, generator: torch.Generator, epochs: int, *,
          batch_size: int = 32, held_out=None,
          log=print) -> list[CoTMParams]:
    """Train from ``params``; returns the parameters after each epoch
    (held-out software accuracy logged per epoch when ``held_out`` is
    ``(literals, labels)``)."""
    out, t0 = [], time.perf_counter()
    for ep in range(epochs):
        params = train_epochs(params, lits, labels, generator, cfg,
                              epochs=1, batch_size=batch_size)
        out.append(params)
        if held_out is not None:
            log(f"  epoch {ep}: held-out software acc "
                f"{accuracy(params, cfg, *held_out):.4f} "
                f"({time.perf_counter() - t0:.1f} s)")
    return out


def digital_kernels(params: CoTMParams, cfg: CoTMConfig,
                    lits: torch.Tensor) -> dict[str, torch.Tensor]:
    """The digital CoTM kernels of the ``"cuda"`` backend on ``lits``:
    ``fused_cotm`` scores, ``class_sum`` over ``clause_eval`` (the unfused
    stages), and the ``clause_eval`` violation counts."""
    bk = backends.get_backend("cuda")
    inc = include_mask(params.ta_state, cfg.n_states)
    ne = inc.any(dim=0)
    w = params.weights.T
    fired = bk.clause_eval(lits, inc, ne)
    return dict(fused=bk.fused_cotm(lits, inc, ne, w),
                staged=bk.class_sum(fired, w), fired=fired,
                viol=bk.clause_eval(lits, inc, ne, mode="viol"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--clauses", type=int, default=500)
    ap.add_argument("--train", type=int, default=8000)
    ap.add_argument("--test", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== 1. data ==")
    lit_tr, y_tr = digit_data(args.train, 1, dev)
    lit_te, y_te = digit_data(args.test, 2, dev)
    print(f"train {tuple(lit_tr.shape)} literals, test "
          f"{tuple(lit_te.shape)}")

    print("== 2. CoTM training ==")
    cfg = paper_config(args.clauses)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = train(cfg.init(gen), cfg, lit_tr, y_tr, gen, args.epochs,
                   held_out=(lit_te, y_te))[-1]
    sw_acc = accuracy(params, cfg, lit_te, y_te)

    print("== 3. crossbar mapping (Y-Flash digital twin) ==")
    t0 = time.perf_counter()
    system = build_system(params, cfg, gen, device=dev)
    st = system.encode_stats
    print(f"  clause tile: {tuple(system.clause_g.shape)} (include frac "
          f"{st['clause']['include_fraction']:.3%}, paper: 2.32%)")
    print(f"  mean encode pulses "
          f"{float(st['clause']['prog_pulses'].float().mean()):.1f} "
          f"(paper ~7); weight shift |W_min| = {st['weight_shift']}")
    print(f"  mapped in {time.perf_counter() - t0:.1f} s")

    print("== 4. in-memory inference (compiled session) ==")
    session = system.compile(RuntimeSpec(backend="cuda", metering="fused",
                                         device=str(dev)))
    result = session.infer_with_report(lit_te)
    rep = result.report
    hw_acc = float((result.predictions == y_te).double().mean())
    n = rep.datapoints
    print(f"  software acc {sw_acc:.4f} | hardware acc {hw_acc:.4f} "
          "(paper: 0.963 sw == hw)")
    print(f"  energy/datapoint: clause "
          f"{rep.clause_energy_j / n * 1e12:.2f} pJ (paper 67.99), class "
          f"{rep.class_energy_j / n * 1e12:.2f} pJ (paper 16.22)")
    print(f"  GOPS {rep.gops:.1f} (paper 413.6) | TOPS/W "
          f"{rep.tops_per_w:.1f} (paper 24.56)")

    print("== 5. digital kernel cross-check ==")
    k = min(256, args.test)
    dig = digital_kernels(params, cfg, lit_te[:k])
    k_pred = dig["fused"].argmax(dim=-1)
    agree = float((k_pred == predict(params, lit_te[:k], cfg)).double()
                  .mean())
    same = (torch.equal(dig["fused"], dig["staged"])
            and torch.equal(dig["fired"], (dig["viol"] == 0)
                            & include_mask(params.ta_state,
                                           cfg.n_states).any(dim=0)))
    print(f"  fused_cotm acc {float((k_pred == y_te[:k]).double().mean()):.4f}"
          f", agreement with software {agree:.1%}; class_sum(clause_eval) "
          f"{'equals' if same else 'DIFFERS FROM'} fused_cotm")
    return dict(sw_acc=sw_acc, hw_acc=hw_acc, report=rep,
                kernel_agreement=agree, kernels_consistent=same)


if __name__ == "__main__":
    main()

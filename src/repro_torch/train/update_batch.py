"""How the size of a batched CoTM update moves held-out accuracy, on the
PyTorch/CUDA port at paper width (K = 1568, n = 500, m = 10, N = 128,
T = 96, s = 8, the quickstart's configuration).

A batched update sums its samples' TA deltas (``core.train.batch_deltas``
and ``train.OnlineTrainer.update`` alike), so its step grows with the
batch.  From the model after one offline epoch (batch 32 over 6000
synthetic digits), this script continues training on 4096 fresh digits
at several batch sizes, offline (``train_step_batch``) and online
(``OnlineTrainer`` on ideal and on variable devices), and prints the
held-out accuracy (1000 digits) every 512 samples: software accuracy for
offline training, (hardware through ``session.predict``, software of the
trainer's digital copy) for online training.

    PYTHONPATH=src python3 -m repro_torch.train.update_batch   # needs a card
"""
from __future__ import annotations

import subprocess
import sys
import time

import torch

from .. import quickstart as qs
from ..core.train import train_step_batch
from ..impact import IMPACTConfig, RuntimeSpec, build_system
from .online import OnlineTrainer

BATCHES = (16, 32, 64)
N_FRESH, EVERY = 4096, 512


def main() -> int:
    if not torch.cuda.is_available():
        print("update_batch: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    lit_tr, y_tr = qs.digit_data(6000, 1, dev)
    lit_ho, y_ho = qs.digit_data(1000, 2, dev)
    lit_on, y_on = qs.digit_data(N_FRESH, 3, dev)
    cfg = qs.paper_config(500)
    gen = torch.Generator(device=dev).manual_seed(0)
    start = qs.train(cfg.init(gen), cfg, lit_tr, y_tr, gen, 1,
                     held_out=(lit_ho, y_ho))[0]

    def acc(p):
        return round(qs.accuracy(p, cfg, lit_ho, y_ho), 4)

    for bs in BATCHES:
        p, g, accs = start, torch.Generator(device=dev).manual_seed(7), []
        for u in range(N_FRESH // bs):
            sl = slice(u * bs, (u + 1) * bs)
            p = train_step_batch(p, lit_on[sl], y_on[sl], g, cfg)
            if (u + 1) * bs % EVERY == 0:
                accs.append(acc(p))
        print(f"offline batch {bs}: software acc {acc(start)} then every "
              f"{EVERY} samples {accs}", flush=True)
    for variability in (False, True):
        for bs in BATCHES:
            g = torch.Generator(device=dev).manual_seed(1)
            system = build_system(start, cfg, g,
                                  IMPACTConfig(variability=variability),
                                  device=dev)
            trainer = OnlineTrainer(
                system.compile(RuntimeSpec(device="cuda")), start, cfg,
                generator=g, variability=variability)
            first = (round(trainer.evaluate(lit_ho, y_ho), 4), acc(start))
            accs, t0 = [], time.perf_counter()
            for u in range(N_FRESH // bs):
                sl = slice(u * bs, (u + 1) * bs)
                trainer.update(lit_on[sl], y_on[sl])
                if (u + 1) * bs % EVERY == 0:
                    accs.append((round(trainer.evaluate(lit_ho, y_ho), 4),
                                 acc(trainer.params)))
            print(f"online batch {bs}, variability={variability}: (hardware,"
                  f" software) acc {first} then every {EVERY} samples "
                  f"{accs}; {time.perf_counter() - t0:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Table 5: seven datasets at the paper's published (classes, clauses,
literals) dimensions, trained and mapped to crossbars (the port of
``benchmarks/table5_datasets.py``).

Real datasets are unavailable offline; synthetic prototype stand-ins are
generated at the exact published dimensionality
(``data.synthetic.table5_dataset``).  The claim checked per dataset: (a)
the CoTM trains to high accuracy at the paper's sizing, (b) the crossbar
mapping preserves that accuracy.

The hardware accuracy comes from ``system.compile(RuntimeSpec())
.predict``: on a card, ``fused_impact`` on each trained system.  Two of
them take two 512-column clause tiles (cifar2: 2048 literals, 1000
clauses; human_activity: 1632, 800), and kws6 (754 literals) and emg
(192) are ragged.  Timings: each row's ``us_per_call`` is the training
wall (no warm-up).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import CoTMConfig, CoTMParams, predict, train_epochs
from ..data.synthetic import TABLE5, table5_dataset
from ..device import resolve_device
from ..impact import IMPACTConfig, IMPACTSystem, RuntimeSpec, build_system
from .common import Row, accuracy, emit, generator, timed

PAPER_ACC = {
    "iris": 96.67, "cifar2": 81.0, "kws6": 80.3, "fashion_mnist": 84.16,
    "emg": 87.0, "gesture_phase": 89.0, "human_activity": 84.0,
}


def literals(x: np.ndarray, device) -> torch.Tensor:
    """Features (n, F) -> literals (n, 2F) bool: features, then their
    negations."""
    return torch.from_numpy(np.concatenate([x, 1 - x], -1).astype(bool)
                            ).to(device)


def run_dataset(name: str, n_train: int = 2000, epochs: int = 6, *,
                device=None, params: CoTMParams | None = None,
                impact_cfg: IMPACTConfig = IMPACTConfig(),
                systems: dict[str, IMPACTSystem] | None = None):
    """Train on ``n_train`` stand-in samples (seed 0), or take ``params``
    trained at this config, then program the system (generator seeded 2,
    ``impact_cfg``) and test both on 400 samples (seed 7).  -> (training
    us, software accuracy, hardware accuracy, the dataset's spec).
    ``systems``, when given, receives the programmed system under
    ``name``."""
    dev = resolve_device(device)
    x, y, spec = table5_dataset(name, n_train, seed=0)
    xt, yt, _ = table5_dataset(name, 400, seed=7)
    lit, lit_t = literals(x, dev), literals(xt, dev)
    y_t = torch.from_numpy(yt).to(device=dev, dtype=torch.int64)
    cfg = CoTMConfig(n_literals=spec["literals"], n_clauses=spec["clauses"],
                     n_classes=spec["classes"], n_states=128, threshold=32,
                     specificity=5.0)
    train_us = 0.0
    if params is None:
        params, train_us = timed(
            dev, train_epochs, cfg.init(generator(dev, 0)), lit,
            torch.from_numpy(y).to(device=dev, dtype=torch.int64),
            generator(dev, 1), cfg, epochs=epochs, batch_size=50)
    params = params.to(dev)
    sw = accuracy(predict(params, lit_t, cfg), y_t)
    system = build_system(params, cfg, generator(dev, 2), impact_cfg,
                          device=dev)
    if systems is not None:
        systems[name] = system
    hw = accuracy(system.compile(RuntimeSpec(device=str(dev))).predict(
        lit_t).predictions, y_t)
    return train_us, sw, hw, spec


def main(*, device=None, names=tuple(TABLE5), n_train: int = 2000,
         epochs: int = 6,
         systems: dict[str, IMPACTSystem] | None = None) -> list[Row]:
    dev = resolve_device(device)
    rows = []
    for name in names:
        us, sw, hw, spec = run_dataset(name, n_train, epochs, device=dev,
                                       systems=systems)
        rows.append(emit(
            f"table5/{name}", us,
            f"sw_acc={sw:.3f};hw_acc={hw:.3f};"
            f"paper={PAPER_ACC[name] / 100:.3f};"
            f"dims={spec['classes']}c/{spec['clauses']}cl/"
            f"{spec['literals']}L;note=synthetic-standin", sw=sw, hw=hw))
    return rows

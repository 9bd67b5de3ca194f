"""Shared pieces of the paper's experiments: CSV rows, gates, the host
timer and the trained MNIST CoTM cache (the port of
``benchmarks/common.py``).

Every section prints ``name,us_per_call,derived`` rows and also returns
them as ``Row`` s, whose ``values`` hold the unrounded numbers behind the
formatted ``derived`` field.  ``us_per_call`` is host wall time between
two ``torch.cuda.synchronize()`` calls (``timed``).
"""
from __future__ import annotations

import dataclasses
import pathlib
import pickle
import sys
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..convert import params_from_arrays
from ..core import CoTMConfig, CoTMParams, predict, train_epochs
from ..device import resolve_device
from ..quickstart import digit_data, paper_config

ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "artifacts"


@dataclasses.dataclass(frozen=True)
class Row:
    """One CSV row of a section, with the numbers it was formatted from."""
    name: str
    us_per_call: float
    derived: str
    values: dict[str, Any] = dataclasses.field(default_factory=dict)

    def csv(self) -> str:
        return f"{self.name},{self.us_per_call:.3f},{self.derived}"


def emit(name: str, us_per_call: float, derived: str, **values) -> Row:
    """Print the reference's ``name,us_per_call,derived`` row; return it as
    a ``Row`` carrying ``values``."""
    row = Row(name, float(us_per_call), derived, values)
    print(row.csv(), flush=True)
    return row


class GateError(RuntimeError):
    """A section's own consistency gate failed."""


def gate_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if not torch.equal(got, want):
        n = int((got != want).sum())
        raise GateError(f"{name}: {n} of {got.numel()} entries differ")


def gate_close(name: str, got: float, want: float, rtol: float) -> None:
    if not abs(got - want) <= rtol * abs(want):
        raise GateError(f"{name}: {got!r} vs {want!r} outside rtol {rtol}")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(device: torch.device, fn: Callable, /, *args, **kwargs):
    """-> (fn's result, host wall in us from a synchronized start to a
    synchronized end)."""
    sync(device)
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    sync(device)
    return out, (time.perf_counter() - t0) * 1e6


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded ``seed``; the sections
    use the seeds where the reference uses ``jax.random.key(seed)``."""
    return torch.Generator(device=device).manual_seed(seed)


class Trained(NamedTuple):
    """A trained CoTM with its test set, unpacked as the reference's
    ``trained_mnist_cotm`` tuple."""
    cfg: CoTMConfig
    params: CoTMParams
    lits: torch.Tensor
    labels: torch.Tensor
    sw_acc: float


def accuracy(pred: torch.Tensor, labels: torch.Tensor) -> float:
    return float((pred.to(labels.device) == labels).double().mean())


def trained_mnist_cotm(n_clauses: int = 500, epochs: int = 10,
                       n_train: int = 8000, tag: str = "bench", *,
                       device=None, cache: bool = True,
                       params: CoTMParams | None = None) -> Trained:
    """Train (or load cached, or take ``params``) a CoTM at the paper's
    MNIST dimensions (``quickstart.paper_config``: K = 1568, m = 10, N =
    128, T = 96, s = 8), batch 32, and test it on 1000 held-out digits.

    The cache is ``artifacts/torch_cotm_{tag}_{n_clauses}c_{epochs}e.pkl``
    (numpy arrays); ``cache=False`` neither reads nor writes it.  Given
    ``params`` (trained at this config), nothing is trained or cached.
    """
    dev = resolve_device(device)
    cfg = paper_config(n_clauses)
    lits, labels = digit_data(1000, 2, dev)
    path = ARTIFACTS / f"torch_cotm_{tag}_{n_clauses}c_{epochs}e.pkl"
    if params is not None:
        params = params.to(dev)
    elif cache and path.exists():
        with open(path, "rb") as f:
            blob = pickle.load(f)
        params = params_from_arrays(blob["ta_state"], blob["weights"],
                                    device=dev)
    else:
        lit_tr, y_tr = digit_data(n_train, 1, dev)
        t0 = time.perf_counter()
        params = train_epochs(cfg.init(generator(dev, 0)), lit_tr, y_tr,
                              generator(dev, 1), cfg, epochs=epochs,
                              batch_size=32)
        sync(dev)
        print(f"# trained CoTM {n_clauses}c x{epochs}ep in "
              f"{time.perf_counter() - t0:.0f}s", file=sys.stderr)
        if cache:
            ARTIFACTS.mkdir(exist_ok=True)
            with open(path, "wb") as f:
                pickle.dump({k: np.asarray(getattr(params, k).cpu())
                             for k in ("ta_state", "weights")}, f)
    return Trained(cfg, params, lits, labels,
                   accuracy(predict(params, lits, cfg), labels))

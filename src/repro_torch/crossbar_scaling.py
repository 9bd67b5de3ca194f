"""Fig. 14 scaling on the port: one logical CoTM split across many
crossbar tiles (the twin of ``examples/crossbar_scaling.py``).

As the tile size limit shrinks, literals split across row shards
(partial clauses combined by the digital AND) and clauses split across
class-tile shards (partial sums added after the ADC): the tile counts
grow, the clause bits stay identical and so do the predictions.  With
``--world-size N`` the same split also runs over N ranks (``gloo``, one
process a rank): the row and class shards go onto the model axis of a
mesh (``sharding.crossbar``: sums of violation counts and of partial
class currents over the process group), and the sharded predictions
must equal the single-device ones.  Ideal devices throughout, so every
prediction is deterministic.

One exception is counted, not hidden: on ideal devices without fine
tuning the class cells take a few conductance levels, so two classes can
score the same in exact arithmetic, and the f32 sums of another tiling
(another order of the shard sums) break such a tie another way.  A
prediction that differs only where its class scores within ``RTOL_TIE``
of the top is reported as a tie; any other difference fails.

Run (on the card, or ``--device cpu`` with the kernels' plain versions):

    PYTHONPATH=src python -m repro_torch.crossbar_scaling [--device cpu]
        [--world-size 2] [--samples 1024] [--epochs 8]

Exits non-zero when the clause bits differ across tilings, or a
prediction differs beyond a tie across tilings or between the sharded
and single-device runs.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .core import CoTMConfig, predict
from .core.train import train_epochs
from .convert import params_from_arrays
from .data.synthetic import prototype
from .device import resolve_device
from .impact import IMPACTConfig, RuntimeSpec, build_system

#: (max_tile_rows, max_tile_cols) of each tiling; ``max_class_rows`` is the
#: column limit, as in the reference example.
TILINGS = ((2048, 512), (128, 64), (64, 32), (32, 16))
N_PREDICT = 512
#: A tie to f32 rounding: the class scores within this of the top.
RTOL_TIE = 1e-6


def model_config() -> CoTMConfig:
    """The example's CoTM: 256 literals, 128 clauses, 6 classes."""
    return CoTMConfig(n_literals=256, n_clauses=128, n_classes=6,
                      n_states=64, threshold=24, specificity=5.0)


def train(n: int, epochs: int, device: torch.device, seed: int = 0):
    """Prototype data -> (trained params, literals (n, 256) bool, labels)."""
    cfg = model_config()
    x, y = prototype(n, n_classes=6, n_features=128, flip=0.05)
    lits = torch.from_numpy(np.concatenate([x, 1 - x], -1).astype(bool))
    labels = torch.from_numpy(y).to(torch.int64)
    gen = torch.Generator(device).manual_seed(seed)
    params = train_epochs(cfg.init(gen), lits.to(device), labels.to(device),
                          gen, cfg, epochs=epochs, batch_size=64)
    return params, lits, labels


def tile_predictions(params, lits: torch.Tensor, device: torch.device, *,
                     mesh=None) -> list[dict]:
    """Program the model at every tiling on ideal devices and predict the
    first ``N_PREDICT`` rows through the default session (its mesh: the
    system's ``mesh``): predictions, scores and, without a mesh, the
    clause bits."""
    cfg = model_config()
    rows_out = []
    x = lits[:N_PREDICT].to(device)
    for rows, cols in TILINGS:
        icfg = IMPACTConfig(variability=False, finetune=False,
                            max_tile_rows=rows, max_tile_cols=cols,
                            max_class_rows=cols)
        system = build_system(params, cfg, None, icfg, device=device,
                              mesh=mesh)
        session = system.compile(RuntimeSpec(device=str(device)))
        res = session.predict(x)
        bits = (None if mesh is not None else
                system.clause_bits(x)[0][:, :cfg.n_clauses].cpu().numpy())
        R, C = system.clause_g.shape[0], system.clause_g.shape[1]
        rows_out.append(dict(tiling=(rows, cols), tiles=R * C,
                             shards=system.class_g.shape[0],
                             plan=session.plan, bits=bits,
                             preds=res.predictions.cpu().numpy(),
                             scores=res.scores.cpu().numpy()))
    return rows_out


def differences(preds: np.ndarray, want: np.ndarray,
                want_scores: np.ndarray) -> tuple[int, int]:
    """(ties, other differences) of ``preds`` against ``want``: a lane
    that differs is a tie when its class scores within ``RTOL_TIE`` of
    the top in ``want_scores``."""
    lanes = np.flatnonzero(preds != want)
    s = want_scores[lanes].astype(np.float64)
    top = s.max(axis=1)
    gap = top - s[np.arange(len(lanes)), preds[lanes]]
    ties = int((gap <= RTOL_TIE * np.abs(top)).sum())
    return ties, len(lanes) - ties


def _rank(rank: int, ta_state: np.ndarray, weights: np.ndarray,
          lits: np.ndarray, device: str, out_dir: str) -> None:
    """One rank of the sharded leg: every rank programs and serves the
    same model on a mesh whose model axis is the whole world."""
    from .launch.mesh import make_crossbar_mesh
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    else:
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // dist.get_world_size()))
    params = params_from_arrays(ta_state, weights, device=dev)
    mesh = make_crossbar_mesh(device_type=dev.type)
    got = tile_predictions(params, torch.from_numpy(lits), dev, mesh=mesh)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             preds=np.stack([r["preds"] for r in got]),
             plans=np.array([str(r["plan"]) for r in got]))


def sharded_predictions(params, lits: torch.Tensor, device: torch.device,
                        world_size: int) -> list[tuple[np.ndarray, list]]:
    """Run ``tile_predictions`` on a mesh over ``world_size`` ranks, every
    rank on the CPU or on the first card -> each rank's (predictions a
    tiling, plans a tiling)."""
    from .launch.mesh import spawn
    with tempfile.TemporaryDirectory() as tmp:
        dev = str(device if device.type == "cpu" else torch.device("cuda", 0))
        spawn(_rank, world_size, params.ta_state.cpu().numpy(),
              params.weights.cpu().numpy(), lits.numpy(), dev, tmp,
              init_method=f"file://{tmp}/store")
        out = []
        for r in range(world_size):
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
                out.append((z["preds"], list(z["plans"])))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--world-size", type=int, default=0,
                    help="also run the tilings sharded over this many "
                         "gloo ranks (0: single device only)")
    ap.add_argument("--samples", type=int, default=1024)
    ap.add_argument("--epochs", type=int, default=8)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    params, lits, labels = train(args.samples, args.epochs, device)
    cfg = model_config()
    sw = float((predict(params, lits.to(device), cfg).cpu() == labels)
               .double().mean())
    print(f"software CoTM accuracy: {sw:.3f}")
    runs = tile_predictions(params, lits, device)
    base = runs[0]
    want = labels[:N_PREDICT].numpy()
    print(f"{'tile limit':>12} {'clause tiles':>13} {'class shards':>13} "
          f"{'bits':>5} {'agreement':>10} {'ties':>5} {'acc':>6}")
    ok = True
    for r in runs:
        same_bits = bool((r["bits"] == base["bits"]).all())
        ties, other = differences(r["preds"], base["preds"], base["scores"])
        ok &= same_bits and other == 0
        rows, cols = r["tiling"]
        print(f"{rows:>6}x{cols:<5} {r['tiles']:>13} {r['shards']:>13} "
              f"{'same' if same_bits else 'DIFF':>5} "
              f"{float((r['preds'] == base['preds']).mean()):>10.1%} "
              f"{ties:>5} {float((r['preds'] == want).mean()):>6.3f}")
    if args.world_size:
        for rank, (preds, plans) in enumerate(sharded_predictions(
                params, lits, device, args.world_size)):
            for r, p, plan in zip(runs, preds, plans):
                ties, other = differences(p, r["preds"], r["scores"])
                ok &= other == 0
                rows, cols = r["tiling"]
                print(f"rank {rank} of {args.world_size}, {rows}x{cols}: "
                      f"plan {plan}, {int((p == r['preds']).sum())} of "
                      f"{len(p)} predictions equal to the single-device "
                      f"run, {ties} ties, {other} other differences")
    if not ok:
        print("clause bits or predictions differ beyond ties: the Fig. 14 "
              "combine is broken")
        return 1
    print("identical clause bits across tilings, and predictions up to "
          "ties" + (" on every rank" if args.world_size else "")
          + ": the Fig. 14 partial-clause AND and partial-sum ADC combine")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What the gloo collectives of the ZeRO step take on one host: a world
of 4 ranks (a 2 x 2 ``make_debug_mesh``) on one device type, each
collective that ``sharding.layout`` and ``train.runtime`` call checked
on small tensors and then timed once on ``--mb`` MB over the mesh's
data axis.

    python -m repro_torch.launch.gloo_rates [--device cuda] [--mb 256]

On ``cuda`` every rank shares the one card (gloo stages the tensors
through host memory itself; NCCL refuses two ranks on one GPU).  Prints
one line a collective: its small-tensor result on rank 0 and the seconds
of the call.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from .mesh import make_debug_mesh, spawn


def _timed(device: torch.device, fn) -> tuple[object, float]:
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _rank(rank: int, device: str, mb: int) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    mesh = make_debug_mesh(2, 2, device_type=dev.type)
    group = mesh.get_group("data")
    x = torch.full((4, 3), float(rank), device=dev)

    def gathered():
        out = torch.empty((8, 3), device=dev)
        dist.all_gather_into_tensor(out, x, group=group)
        return out[:, 0].tolist()

    def scattered():
        out = torch.empty((4, 3), device=dev)
        dist.reduce_scatter_tensor(out, torch.arange(
            24.0, device=dev).reshape(8, 3) + rank, group=group)
        return out[:, 0].tolist()

    def summed():
        y = x.clone()
        dist.all_reduce(y, group=group)
        return float(y[0, 0])

    n = mb * (1 << 20) // 4
    big = torch.ones(n, device=dev)

    def big_gather():
        out = torch.empty(2 * n, device=dev)
        dist.all_gather_into_tensor(out, big, group=group)

    def big_scatter():
        out = torch.empty(n // 2, device=dev)
        dist.reduce_scatter_tensor(out, big, group=group)

    def big_sum():
        dist.all_reduce(big, group=group)

    lines = []
    for name, fn in (("all_gather_into_tensor", gathered),
                     ("reduce_scatter_tensor", scattered),
                     ("all_reduce", summed),
                     (f"all_gather_into_tensor of {mb} MB (out "
                      f"{2 * mb} MB)", big_gather),
                     (f"reduce_scatter_tensor of {mb} MB", big_scatter),
                     (f"all_reduce of {mb} MB", big_sum)):
        out, s = _timed(dev, fn)
        lines.append(f"{dev.type} {name}: {out} {s:.3f} s")
    if rank == 0:
        print("\n".join(lines), flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mb", type=int, default=256)
    args = ap.parse_args(argv)
    print(f"torch {torch.__version__}; a gloo world of 4 on "
          f"{args.device}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_rank, 4, args.device, args.mb,
              init_method=f"file://{tmp}/store")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The production dry run on the ``meta`` device: every (arch x shape x
mesh) cell's per-rank memory, FLOPs and collective bytes against one
H100's memory (the port of ``repro.launch.dryrun``).

Each cell runs the port's own step, as a rank of the production mesh
would, in a ``launch.mesh.fake_world`` of 256 (16 x 16) or 512 (2 x 16
x 16) ranks in this one process: the model built tensor parallel on
``meta`` (``build(cfg, ShardCtx(mesh, merged_rules(mesh, zero3=)))``,
parameters not drawn), then

* ``train``   — the ZeRO + TP AdamW step (``zero_shardings``,
  ``shard_state`` with ``cfg.opt_moment_dtype``, ``make_train_step``) on
  ``train_batch_specs``, ``shape.accum`` microbatches;
* ``prefill`` — ``model.prefill`` on this rank's block of
  ``prefill_specs`` (``prefill_axes``);
* ``decode``  — ``model.decode_step`` on ``decode_specs`` (this rank's
  rows and cache blocks).

Like the reference's dry run, serving cells hold bf16 parameters and
training cells f32 masters.  The step runs under ``census.Census`` (dot
FLOPs, op-boundary bytes, peak live bytes) and
``sharding.layout.record_traffic`` (the collectives); the record keeps
the reference's keys where they mean the same thing (``memory``:
``argument_size_in_bytes`` this rank's parameters, optimizer state and
batch or cache, ``output_size_in_bytes``, ``alias_size_in_bytes`` the
outputs written in place into an argument, ``temp_size_in_bytes`` the
peak of the bytes made during the step; ``cost``: ``flops``, ``bytes
accessed``; ``collectives``: ``collective_summary`` and
``by_axis``), and adds ``state_size_in_bytes`` (parameters and moments),
``rank``, ``depth_run`` and ``fits`` (arguments plus temp within
``HBM_BYTES``).  A cell runs as rank 0 and as the last rank; the record
is the one that needs more memory.

Size.  Meta execution costs Python dispatch time that grows with depth
and microbatches, so a cell runs cut and is extrapolated exactly (the
tests hold the extrapolation to uncut runs):

* ``train`` runs at full depth with 1 and 2 microbatches: every count
  of ``shape.accum`` microbatches is the first's plus (accum - 1) times
  the second's increment (microbatches 2, 3, ... run the same ops on
  the same live storages), and the peak is the two-microbatch run's.
  Depth is not cut: a train step's live bytes grow per layer at several
  places (saved layer inputs, the gathered weights, a stacked leaf's
  gradient and its copies), so its peak is a max of lines of different
  slopes and can switch between them deeper than a cut run reaches
  (grok-1 ``train_4k``: +1.32 GB a layer at depths 2-4, +2.15 GB at 6);
* ``prefill`` / ``decode`` run at two depths d1 < d2, one period of the
  config's layer pattern apart (``depths``): each holds deepseek's dense
  front layer, at least one of zamba2's groups of ``hybrid_attn_every``
  mamba layers and the shared block, the tail that ``n_layers`` leaves,
  and at least two layers on every stacked axis (on an axis of one, some
  ``.contiguous()`` copies vanish).  Each period adds the same ops,
  bytes and collectives, so every count is affine in the number of
  periods.  Under ``no_grad`` a layer's storages die within it or
  persist to the end (the cache), so the peak is affine too once it
  grows as the persistent outputs do; where it does not between d1 and
  d2, the cell runs at full depth and says why (``full_depth``).

The arguments come from the uncut tree, which costs nothing on
``meta``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --table

Records land in ``artifacts/torch_dryrun/<16x16|2x16x16>/<arch>__<shape>
.json``.  A cell that fails is recorded with its error and traceback;
the command then exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import sys
import time
import traceback
from fractions import Fraction

import torch

from ..configs import ARCH_IDS, SHAPES, cells, get_config
from ..models import NULL_CTX, ShardCtx, build, torch_dtype
from ..sharding import layout
from ..sharding.rules import merged_rules
from ..train.optimizer import AdamWConfig, init_state, shard_state
from ..train.step import make_train_step, zero_shardings
from .census import Census, collective_summary
from .mesh import fake_world, make_debug_mesh
from .specs import (decode_specs, prefill_axes, prefill_specs,
                    train_batch_specs)

ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "artifacts"
MESHES = {"single": (16, 16), "multi": (2, 16, 16)}
#: The card the record's ``fits`` is held against, and its memory:
#: ``torch.cuda.get_device_properties(0).total_memory`` on that card
#: (``chip_smoke.py`` phase 17 prints it), used where no card is present.
HBM_NAME = "NVIDIA H100 80GB HBM3"
HBM_BYTES = 85_017_493_504


def mesh_name(mesh_shape) -> str:
    return "x".join(map(str, mesh_shape)) if mesh_shape else "1"


def hbm() -> dict:
    """The card ``fits`` is held against: this process's card 0 where
    there is one, else ``HBM_NAME``'s ``HBM_BYTES``."""
    if torch.cuda.is_available():
        return {"device": torch.cuda.get_device_name(0),
                "bytes": torch.cuda.get_device_properties(0).total_memory}
    return {"device": HBM_NAME, "bytes": HBM_BYTES}


def depths(cfg) -> tuple[int, int] | None:
    """(d1, d2) to run and extrapolate from (module docstring), or None
    where ``n_layers`` is not deeper than d2 (the cell runs whole)."""
    period = cfg.hybrid_attn_every or 1
    front = cfg.moe.first_dense_layers if cfg.moe else 0
    tail = (cfg.n_layers - front) % period
    d1 = front + tail + period * max(1, -(-(2 - tail) // period))
    d2 = d1 + period
    return (d1, d2) if d2 < cfg.n_layers else None


def _nbytes(tensors) -> int:
    """The bytes of ``tensors``, each counted once (a view: its own
    elements, as a rank holds its block of a global input)."""
    return sum(t.numel() * t.element_size()
               for t in {id(t): t for t in tensors}.values())


def _held(tensors) -> int:
    """The bytes of the storages under ``tensors``, each counted once."""
    return sum({id(s): s.nbytes() for s in (
        t.untyped_storage() for t in tensors)}.values())


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if dataclasses.is_dataclass(tree):
        return _tensors([getattr(tree, f.name)
                         for f in dataclasses.fields(tree)])
    return []


def _setup(cfg, shape, mesh, inputs=None, max_len=None):
    """-> (the step as a function of nothing, its arguments, the bytes of
    its parameters and moments) of ``cfg`` on ``mesh`` (None: one
    device), on ``meta``; ``inputs`` and ``max_len`` as ``measure``
    takes them."""
    ctx = (ShardCtx(mesh, merged_rules(mesh, zero3=cfg.zero3))
           if mesh is not None else NULL_CTX)
    model = build(cfg, ctx, device="meta")
    if shape.kind == "train":
        opt = AdamWConfig(moment_dtype=torch_dtype(cfg.opt_moment_dtype))
        params = model.abstract(torch_dtype(cfg.param_dtype))
        batch = inputs or train_batch_specs(cfg, shape)
        if mesh is None:
            state = init_state(params, opt)
            step = make_train_step(model, opt, device="meta")
            local = batch
        else:
            psh, gsh = zero_shardings(model, mesh)
            state = shard_state(params, opt, psh, gsh)
            step = make_train_step(model, opt, gsh, param_shardings=psh,
                                   device="meta")
            local = step.local_batch(batch)[0]
        del params
        held = _tensors([state.params, state.m, state.v])
        return (lambda: step(state, batch, 0), [state, local],
                _nbytes(held))
    held = list(model.parameters())
    if shape.kind == "prefill":
        batch = inputs or prefill_specs(cfg, shape)
        pa = prefill_axes(cfg)
        local = {k: ctx.local(v, *pa[k]) for k, v in batch.items()}
        n = max_len or shape.seq_len

        def run():
            with torch.no_grad():
                return model.prefill(local["tokens"], local.get("positions"),
                                     n, local.get("extra_embeds"))
        return run, [held, local], _nbytes(held)
    B = shape.global_batch
    rows = (ctx.sharding((B,), ("batch",)).shard_shape((B,))[0]
            if mesh is not None else B)
    d = decode_specs(cfg, dataclasses.replace(shape, global_batch=rows),
                     model)

    def run():
        with torch.no_grad():
            return model.decode_step(d["cache"], d["tokens"],
                                     d["positions"])
    return run, [held, d], _nbytes(held)


def _affine(q1: dict, q2: dict, k: int) -> dict:
    """q1 + k (q2 - q1), key by key (a missing key counts 0)."""
    return {key: q1.get(key, 0) + k * (q2.get(key, 0) - q1.get(key, 0))
            for key in q1.keys() | q2.keys()}


def _microbatches(shape, inputs, a: int) -> tuple:
    """(``shape``, ``inputs``) cut to their first ``a`` microbatches."""
    cut = dataclasses.replace(shape, accum=a, global_batch=(
        shape.global_batch // shape.accum * a))
    return cut, inputs and {k: v[:a] for k, v in inputs.items()}


def _counts(cfg, shape, mesh, inputs, max_len, extrapolate: bool):
    """-> (the cell's counts, the sizes run, why it ran at full depth or
    None): cut and extrapolated as the module docstring says."""
    whole = {"depth_run": [cfg.n_layers]}
    if shape.kind == "train":
        whole["accum_run"] = [shape.accum]
        if not extrapolate or shape.accum <= 2:
            return _run(cfg, shape, mesh, inputs, max_len), whole, None
        q1, q2 = (_run(cfg, cut, mesh, cut_inputs, max_len)
                  for cut, cut_inputs in (_microbatches(shape, inputs, a)
                                          for a in (1, 2)))
        q = _affine(q1, q2, shape.accum - 1)
        q["temp"] = q2["temp"]
        return q, dict(whole, accum_run=[1, 2]), None
    run = depths(cfg) if extrapolate else None
    if run is None:
        return _run(cfg, shape, mesh, inputs, max_len), whole, None
    q1, q2 = (_run(dataclasses.replace(cfg, n_layers=d), shape, mesh,
                   inputs, max_len) for d in run)
    new = [q["output"] - q["alias"] for q in (q1, q2)]
    if q2["temp"] - q1["temp"] != new[1] - new[0]:
        why = (f"the peak grew {q2['temp'] - q1['temp']} B from depth "
               f"{run[0]} to {run[1]}, the persistent outputs "
               f"{new[1] - new[0]} B")
        return _run(cfg, shape, mesh, inputs, max_len), whole, why
    k = (cfg.n_layers - run[0]) // (run[1] - run[0])
    return _affine(q1, q2, k), {"depth_run": list(run)}, None


def _run(cfg, shape, mesh, inputs, max_len) -> dict:
    """One run of the step at ``cfg``'s depth: its counts, exact (ints,
    and the link bytes as fractions)."""
    fn, args, _ = _setup(cfg, shape, mesh, inputs, max_len)
    arg_ids = {id(t.untyped_storage()) for t in _tensors(args)}
    with layout.record_traffic() as sent, Census() as census:
        out = fn()
    outs = _tensors(out)
    kinds = collective_summary(sent.ops)["by_kind"]
    q = {"flops": census.flops, "bytes": census.bytes,
         "temp": census.peak, "output": _held(outs),
         "alias": _held([t for t in outs
                         if id(t.untyped_storage()) in arg_ids])}
    q.update({f"axis/{a}": Fraction(b) for a, b in sent.bytes.items()})
    for k, v in kinds.items():
        q[f"count/{k}"] = v["count"]
        q[f"kind/{k}"] = Fraction(v["bytes"])
    return q


def measure(cfg, shape, mesh_shape=None, *, rank: int = 0, inputs=None,
            max_len: int | None = None, extrapolate: bool = True) -> dict:
    """The dry run of ``cfg`` on ``shape`` (a ``ShapeSpec``) as rank
    ``rank`` of a fake world of ``mesh_shape`` ((data, model) or (pod,
    data, model); None: one device, no process group), on ``meta``.
    ``inputs`` replaces a train or prefill step's batch of the specs by
    the given global tensors; ``max_len`` is the prefill's cache length
    (default ``shape.seq_len``).  With ``extrapolate`` the step runs cut
    (module docstring).  -> the record's ``memory``, ``cost``,
    ``collectives``, ``fits``, ``rank``, ``depth_run`` (``accum_run``:
    the microbatches of a train step run) and ``n_params``."""
    t0 = time.perf_counter()
    world = math.prod(mesh_shape) if mesh_shape else 0
    with (fake_world(world, rank) if world else contextlib.nullcontext()):
        if world and len(mesh_shape) == 3 and mesh_shape[0] != 2:
            raise ValueError(f"a multi-pod mesh has 2 pods: {mesh_shape}")
        mesh = (make_debug_mesh(*mesh_shape[-2:], multi_pod=len(
            mesh_shape) == 3, device_type="cpu") if world else None)
        q, sizes, why = _counts(cfg, shape, mesh, inputs, max_len,
                                extrapolate)
        _, args, state = _setup(cfg, shape, mesh, inputs, max_len)
        arguments = _nbytes(_tensors(args))
        n_params = build(cfg, device="meta").n_params()
    card = hbm()
    by_kind = {key[5:]: {"count": int(q[f"count/{key[5:]}"]),
                         "bytes": float(v)}
               for key, v in sorted(q.items()) if key.startswith("kind/")}
    rec = {
        "kind": shape.kind, "n_params": n_params, "rank": rank, **sizes,
        "memory": {"argument_size_in_bytes": arguments,
                   "output_size_in_bytes": int(q["output"]),
                   "alias_size_in_bytes": int(q["alias"]),
                   "temp_size_in_bytes": int(q["temp"]),
                   "state_size_in_bytes": state},
        "cost": {"flops": float(q["flops"]),
                 "bytes accessed": float(q["bytes"])},
        "collectives": {
            "total_link_bytes": sum(v["bytes"] for v in by_kind.values()),
            "by_kind": by_kind,
            "by_axis": {key[5:]: float(v) for key, v in sorted(q.items())
                        if key.startswith("axis/")}},
        "hbm": card,
        "fits": arguments + int(q["temp"]) <= card["bytes"],
    }
    if len(sizes.get("accum_run", [])) == 2:
        rec["reduced"] = "microbatches, extrapolated exactly"
    elif len(sizes["depth_run"]) == 2:
        rec["reduced"] = "depth, extrapolated exactly"
    elif why:
        rec["full_depth"] = why
    rec["lower_s"] = round(time.perf_counter() - t0, 1)
    return rec


def serving_config(cfg, kind: str):
    """The reference dry run's posture: serving cells hold bf16
    parameters, training cells the config's f32 masters."""
    return cfg if kind == "train" else dataclasses.replace(
        cfg, param_dtype="bfloat16")


def lower_cell(arch: str, shape_name: str, multi_pod: bool, *,
               rank: int = 0, mutate_cfg=None) -> dict:
    """One cell's record as rank ``rank`` of the production mesh."""
    cfg = get_config(arch)
    if mutate_cfg is not None:
        cfg = mutate_cfg(cfg)
    shape = SHAPES[shape_name]
    mesh_shape = MESHES["multi" if multi_pod else "single"]
    rec = dict(arch=arch, shape=shape_name, mesh=mesh_name(mesh_shape))
    rec.update(measure(serving_config(cfg, shape.kind), shape, mesh_shape,
                       rank=rank))
    return rec


def _need(rec: dict) -> int:
    m = rec["memory"]
    return m["argument_size_in_bytes"] + m["temp_size_in_bytes"]


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: pathlib.Path | None = None, mutate_cfg=None) -> dict:
    """One cell as rank 0 and as the last rank, the record of the one
    that needs more memory (rank 0 where they tie); a skip for
    ``long_500k`` on a full-attention architecture, an ``error`` record
    (with its traceback) where the cell fails.  Written to
    ``out_dir/<arch>__<shape>.json`` when given."""
    multi = mesh_kind == "multi"
    mesh = mesh_name(MESHES[mesh_kind])
    if not cells(arch)[shape_name]:
        record = dict(arch=arch, shape=shape_name, mesh=mesh,
                      skipped="long_500k requires sub-quadratic attention; "
                              "full-attention arch (see DESIGN.md)")
    else:
        try:
            t0 = time.perf_counter()
            last = math.prod(MESHES[mesh_kind]) - 1
            recs = [lower_cell(arch, shape_name, multi, rank=r,
                               mutate_cfg=mutate_cfg) for r in (0, last)]
            record = max(recs, key=_need)
            record["lower_s"] = round(time.perf_counter() - t0, 1)
        except Exception as e:
            record = dict(arch=arch, shape=shape_name, mesh=mesh,
                          error=f"{type(e).__name__}: {e}",
                          traceback=traceback.format_exc()[-4000:])
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{arch}__{shape_name}.json"
        path.write_text(json.dumps(record, indent=1))
    return record


def table(out: pathlib.Path) -> str:
    """The records under ``out`` (both meshes) as one markdown table: a
    rank's state and peak (arguments + temp) GiB, whether it fits, its
    TFLOP a step and the GB it sends over each mesh axis; the skips and
    the cells without a record in a line after it."""
    head = ["arch", "shape"]
    for mesh in MESHES.values():
        axes = ("pod / " if len(mesh) == 3 else "") + "data / model"
        head += [f"{mesh_name(mesh)} state / peak GiB", "fits", "TFLOP",
                 f"GB {axes}"]
    rows = ["| " + " | ".join(head) + " |", "|" + "---|" * len(head)]
    skipped, missing = set(), []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            row = [arch, shape]
            for mesh in MESHES.values():
                path = out / mesh_name(mesh) / f"{arch}__{shape}.json"
                rec = json.loads(path.read_text()) if path.exists() else {}
                if "memory" not in rec:
                    if "skipped" in rec:
                        skipped.add(f"{arch} {shape}")
                    else:
                        missing.append(f"{arch} {shape} {mesh_name(mesh)}")
                    row += ["-"] * 4
                    continue
                m, ax = rec["memory"], rec["collectives"]["by_axis"]
                row += [f"{m['state_size_in_bytes'] / 2**30:.2f} / "
                        f"{_need(rec) / 2**30:.2f}",
                        "yes" if rec["fits"] else "**no**",
                        f"{rec['cost']['flops'] / 1e12:.1f}",
                        " / ".join(f"{ax.get(a, 0) / 1e9:.2f}" for a in
                                   ("pod", "data", "model")[3 - len(mesh):])]
            if f"{arch} {shape}" not in skipped:
                rows.append("| " + " | ".join(row) + " |")
    notes = [f"Skipped: {', '.join(sorted(skipped))}."] if skipped else []
    notes += [f"No record: {', '.join(missing)}."] if missing else []
    return "\n".join(rows + ([""] + notes if notes else []))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACTS / "torch_dryrun"))
    ap.add_argument("--table", action="store_true",
                    help="print the records under --out as a markdown "
                         "table; run nothing")
    args = ap.parse_args(argv)
    if args.table:
        print(table(pathlib.Path(args.out)))
        return 0
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all (or --table)")

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    todo = ([(a, s) for a in ARCH_IDS for s in SHAPES] if args.all
            else [(args.arch, args.shape)])
    errors = 0
    t0 = time.perf_counter()
    for mesh_kind in meshes:
        out_dir = pathlib.Path(args.out) / mesh_name(MESHES[mesh_kind])
        for arch, shape_name in todo:
            rec = run_cell(arch, shape_name, mesh_kind, out_dir)
            status = ("SKIP" if "skipped" in rec
                      else "ERR " if "error" in rec else "OK  ")
            errors += "error" in rec
            line = (f"[{status}] {rec['mesh']:8s} {arch:24s} "
                    f"{shape_name:12s} lower={rec.get('lower_s', '-')}s")
            if "memory" in rec:
                m = rec["memory"]
                line += (f" state={m['state_size_in_bytes'] / 2**30:.2f}"
                         f"GiB peak={_need(rec) / 2**30:.2f}GiB"
                         f" fits={rec['fits']}"
                         f" flops={rec['cost']['flops']:.4g}")
            print(line, flush=True)
            if "error" in rec:
                print(rec.get("traceback", "")[-2000:], flush=True)
    print(f"dry run: {errors} error(s), {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())

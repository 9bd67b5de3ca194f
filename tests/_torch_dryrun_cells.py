"""The program of ``tests/test_torch_dryrun.py``'s subprocess: every fake
world of that module runs here, in a process of its own (the fake
process group is process-global).

``main(out, part)`` writes ``out`` (JSON), of its part:

* ``mesh`` — ``make_production_mesh`` on fake worlds of 256 and 512
  ranks (shape, axis names, the last rank's coordinate), what it raises
  on other worlds, and whether ``fake_world`` leaves a group behind
  after an error or refuses to nest;
* ``arguments`` — each cell's argument and state bytes on both
  production meshes (``dryrun._setup``, rank 0);
* ``depth`` — for each of ``DEPTH_CASES`` the records of the dry run
  cut and extrapolated (train: 1 and 2 of TRAIN_ACCUM microbatches;
  prefill and decode: ``depths``) and run uncut;
* ``cells`` — ``run_cell``'s records of a skipped cell and of a cell
  whose config fails;
* ``full`` — llama3-8b's ``decode_32k`` on 16 x 16 at full width and
  depth, with the growth of this process's peak RSS over it, and the
  same cell extrapolated.

This module imports neither JAX nor the reference package.
"""
import dataclasses
import json
import math
import resource
import sys
import warnings

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (fake_world, make_debug_mesh,
                                     make_production_mesh)

# (architecture, depth, mesh): smoke configs deep enough that the two
# runs of ``depths`` are shorter than the whole (zamba2 with its tail);
# None: one device (grok-1 accumulates its gradients in bf16 there)
DEPTH_CASES = (("llama3-8b", 4, (2, 2)), ("llama3-8b", 4, (2, 2, 2)),
               ("deepseek-v2-lite-16b", 5, (2, 2)),
               ("grok-1-314b", 4, None), ("qwen2-vl-2b", 4, (1, 4)),
               ("musicgen-large", 4, (2, 2)), ("rwkv6-7b", 4, (2, 2)),
               ("zamba2-7b", 7, (1, 4)))
# the DEPTH_CASES each part runs (the parts take about as long)
PARTS = {"a": (0, 3, 6), "b": (1, 2, 4), "c": (5, 7)}
KINDS = ("train_4k", "prefill_32k", "decode_32k")
TRAIN_ACCUM = 3        # microbatches of the train cases, cut to 1 and 2
VLM_PATCHES = 12       # the VLM's patch embeddings at the smoke size


def depth_config(arch: str, n_layers: int):
    return dataclasses.replace(get_config(arch).smoke(), n_layers=n_layers)


def depth_shape(name: str):
    shape = SHAPES[name].smoke()
    if shape.kind != "train":
        return shape
    return dataclasses.replace(shape, accum=TRAIN_ACCUM,
                               global_batch=TRAIN_ACCUM * shape.global_batch)


def depth_inputs(cfg, shape):
    """The VLM's inputs with VLM_PATCHES patch embeddings in place of the
    specs' 256 (None: the specs'), as ``meta`` tensors."""
    if cfg.modality != "vlm" or shape.kind == "decode":
        return None
    lead = (shape.accum,) if shape.kind == "train" else ()
    B, S = shape.global_batch // shape.accum, shape.seq_len
    z = lambda s, dt: torch.empty(lead + s, dtype=dt, device="meta")
    return {"tokens": z((B, S - VLM_PATCHES), torch.int32),
            "extra_embeds": z((B, VLM_PATCHES, cfg.d_model),
                              torch.bfloat16),
            "positions": z((3, B, S), torch.int32)}


def _raises(fn) -> str:
    try:
        fn()
    except Exception as e:
        return type(e).__name__
    return ""


def _meshes() -> dict:
    out = {}
    for world, multi in ((256, False), (512, True)):
        with fake_world(world, world - 1):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            out[str(world)] = dict(shape=list(mesh.shape),
                                   names=list(mesh.mesh_dim_names),
                                   coordinate=list(mesh.get_coordinate()))
            out[f"{world}/other"] = _raises(lambda: make_production_mesh(
                multi_pod=not multi, device_type="cpu"))
    with fake_world(4):
        out["4"] = _raises(lambda: make_production_mesh(device_type="cpu"))
        out["nested"] = _raises(lambda: fake_world(4).__enter__())
        out["outer_kept"] = dist.is_initialized()

    def fail():
        with fake_world(8):
            raise KeyError("inside")
    out["error"] = _raises(fail)
    out["left_after_error"] = dist.is_initialized()
    return out


def _arguments() -> dict:
    out = {}
    for kind, shape in dryrun.MESHES.items():
        with fake_world(math.prod(shape)):
            mesh = make_debug_mesh(16, 16, multi_pod=kind == "multi",
                                   device_type="cpu")
            for arch in ARCH_IDS:
                for name, ok in cells(arch).items():
                    if not ok:
                        continue
                    cfg = dryrun.serving_config(get_config(arch),
                                                SHAPES[name].kind)
                    _, args, state = dryrun._setup(cfg, SHAPES[name], mesh)
                    out[f"{arch}/{name}/{kind}"] = dict(
                        arguments=dryrun._nbytes(dryrun._tensors(args)),
                        state=state)
    return out


def _depth(cases) -> dict:
    out = {}
    for arch, n, mesh in cases:
        cfg = depth_config(arch, n)
        for name in KINDS:
            shape = depth_shape(name)
            key = f"{arch}/{n}/{dryrun.mesh_name(mesh)}/{name}"
            out[key] = {how: dryrun.measure(
                cfg, shape, mesh, inputs=depth_inputs(cfg, shape),
                extrapolate=how == "extrapolated")
                for how in ("extrapolated", "full")}
    return out


def _cells() -> dict:
    def boom(cfg):
        raise ValueError("a config that cannot be built")
    return dict(
        skip=dryrun.run_cell("llama3-8b", "long_500k", "single"),
        error=dryrun.run_cell("llama3-8b", "decode_32k", "multi",
                              mutate_cfg=boom))


def _full() -> dict:
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rec = dryrun.measure(dryrun.serving_config(get_config("llama3-8b"),
                                               "decode"),
                         SHAPES["decode_32k"], dryrun.MESHES["single"],
                         extrapolate=False)
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    return dict(record=rec, rss_growth_bytes=grown * 1024,
                extrapolated=dryrun.lower_cell("llama3-8b", "decode_32k",
                                               False))


def main(out: str, part: str) -> None:
    """The depth cases of ``PARTS[part]``, and in part ``"a"`` also
    ``full``, ``mesh``, ``arguments`` and ``cells`` (the module runs the
    parts in parallel)."""
    warnings.filterwarnings("ignore", category=FutureWarning)
    res = dict(depth=_depth([DEPTH_CASES[i] for i in PARTS[part]]))
    if part == "a":
        res.update(full=_full(), mesh=_meshes(), arguments=_arguments(),
                   cells=_cells())
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(*sys.argv[1:])

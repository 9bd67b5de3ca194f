"""The port's production dry run (``repro_torch.launch.dryrun``,
``launch.census``, ``launch.mesh.make_production_mesh`` /
``fake_world``) against the reference's accounting, on the CPU.

Every fake world runs in a subprocess (the fake process group is
process-global): ``tests/_torch_dryrun_cells.py``, in three parts that
run in parallel, writes what the tests below read.

* ``CollectiveOp.link_bytes`` and ``collective_summary`` equal
  ``repro.launch.hlo``'s on the same ops, for all five kinds, and
  ``sharding.layout.record_traffic`` lists each call as one.
* ``make_production_mesh`` builds 16 x 16 and 2 x 16 x 16 on fake worlds
  of 256 and 512 ranks and raises on other worlds; ``fake_world``
  refuses to nest and leaves no group behind, after an error too.
* Each cell's argument bytes equal the sum of the reference's shard
  shapes over the same logical axes (``repro.models.base.ShardCtx`` on a
  ``FakeMesh``): training, the f32 parameters by ``param_rules`` (ZeRO-3
  where the config asks), the moments by ``opt_rules``, the step and the
  batch's block; serving, the bf16 parameters by ``param_rules`` without
  ZeRO-3 (the port's serving model holds its block over the model axis,
  whole over the data axes), and the block of the prefill's inputs or
  of the decode step's tokens, positions and cache.
* The extrapolation of a cut run equals the uncut run exactly (FLOPs,
  op bytes, link bytes by kind and axis, peak, outputs, aliases,
  arguments): train steps of 3 microbatches from 1 and 2, prefill and
  decode steps from two shorter depths, at smoke configs deep enough to
  need it, on (2, 2), (2, 2, 2), (1, 4) and one device; and at full width
  and depth for llama3-8b's ``decode_32k`` on 16 x 16, which grows the
  subprocess's peak RSS by under 1 GB: nothing was materialised.
* ``run_cell`` records ``long_500k`` of a full-attention architecture as
  a skip, and a cell that fails as an ``error`` with its traceback.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import hlo as jhlo
from repro.launch import specs as jspecs
from repro.models import build as jbuild
from repro.models.base import ShardCtx as JShardCtx
from repro.sharding import rules as jrules
from repro_torch.launch import census
from repro_torch.sharding import layout

import _torch_dryrun_cells as cells

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"
GROUPS = (1, 2, 3, 4, 16, 256)
MESHES = {"single": dict(data=16, model=16),
          "multi": dict(pod=2, data=16, model=16)}
CELLS = [(a, s, m) for m in MESHES for a in jconfigs.ARCH_IDS
         for s, ok in jconfigs.cells(a).items() if ok]
DEPTH = [f"{a}/{n}/{'x'.join(map(str, m)) if m else '1'}/{k}"
         for a, n, m in cells.DEPTH_CASES for k in cells.KINDS]
RSS_LIMIT = 1 << 30


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), str(HERE)] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import _torch_dryrun_cells as c; "
         f"c.main({str(tmp / part)!r}, {part!r})"], env=env, cwd=HERE)
        for part in cells.PARTS]
    assert [p.wait(timeout=600) for p in procs] == [0] * len(procs)
    res = json.loads((tmp / "a").read_text())
    for part in cells.PARTS:
        res["depth"].update(json.loads((tmp / part).read_text())["depth"])
    return res


# -- the collective inventory ---------------------------------------------

@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("kind", census.KINDS)
def test_link_bytes_equal_the_reference(kind, group):
    for out_b, in_b in ((4096, 1024), (1 << 30, 1 << 26), (6, 6)):
        got = census.CollectiveOp(kind, out_b, in_b, group, "model")
        want = jhlo.CollectiveOp(kind, out_b, in_b, group, "")
        assert got.link_bytes == want.link_bytes


def test_collective_summary_equals_the_reference():
    rng = np.random.default_rng(0)
    specs = [(census.KINDS[i % 5], int(rng.integers(1, 1 << 20)),
              int(rng.integers(1, 1 << 20)), int(rng.choice(GROUPS)))
             for i in range(40)]
    got = census.collective_summary(
        [census.CollectiveOp(*s, "data") for s in specs])
    want = jhlo.collective_summary([jhlo.CollectiveOp(*s, "") for s in specs])
    assert got == want


def test_traffic_lists_each_call_as_a_collective_op():
    """``record_traffic``'s ``ops`` hold each call's kind, output and input
    bytes and group size; their link bytes add up to ``bytes`` by axis."""
    t = torch.zeros(3, 4)
    with layout.record_traffic() as rec:
        layout._count("all_gather", "model", t, 3, 4)
        layout._count("reduce_scatter", "data", t, 0.5, 2)
        layout._count("all_reduce", "model", t, 1.5, 4)
        layout._count("gather", "world", t, 1, 2)
    assert rec.ops == [
        census.CollectiveOp("all-gather", 192, 48, 4, "model"),
        census.CollectiveOp("reduce-scatter", 24, 48, 2, "data"),
        census.CollectiveOp("all-reduce", 48, 48, 4, "model"),
        census.CollectiveOp("collective-permute", 48, 48, 2, "world")]
    by_axis = {}
    for op in rec.ops:
        by_axis[op.axis] = by_axis.get(op.axis, 0.0) + op.link_bytes
    assert by_axis == rec.bytes


# -- meshes and the fake world ---------------------------------------------

def test_production_meshes_on_fake_worlds(dry):
    m = dry["mesh"]
    assert m["256"] == dict(shape=[16, 16], names=["data", "model"],
                            coordinate=[15, 15])
    assert m["512"] == dict(shape=[2, 16, 16],
                            names=["pod", "data", "model"],
                            coordinate=[1, 15, 15])
    assert m["256/other"] == m["512/other"] == m["4"] == "ValueError"


def test_fake_world_leaves_no_group(dry):
    m = dry["mesh"]
    assert m["nested"] == "RuntimeError" and m["outer_kept"]
    assert m["error"] == "KeyError" and not m["left_after_error"]


# -- argument bytes against the reference's shard shapes -----------------

class FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)


def _shard_bytes(tree, axes, ctx, itemsize=None) -> int:
    """Sum over the leaves of ``tree`` (``ShapeDtypeStruct`` s) of this
    rank's block under ``ctx`` (logical ``axes``), in bytes."""
    sizes = ctx.mesh.shape

    def block(sds, ax):
        spec = ctx.spec(sds.shape, tuple(ax))
        n = 1
        for d, e in zip(sds.shape, tuple(spec) + (None,) * len(sds.shape)):
            names = () if e is None else (e if isinstance(e, tuple) else (e,))
            n *= d // int(np.prod([sizes[a] for a in names]))
        return n * (itemsize or jnp.dtype(sds.dtype).itemsize)
    return int(sum(jax.tree.leaves(jax.tree.map(block, tree, axes))))


def _reference_arguments(arch: str, shape: str, mesh: str) -> tuple:
    """(arguments, state) bytes of a rank from the reference's shard
    shapes (module docstring)."""
    jcfg, jshape = jconfigs.get_config(arch), jconfigs.SHAPES[shape]
    fm = FakeMesh(**MESHES[mesh])
    model = jbuild(jcfg)
    act = JShardCtx(fm, jrules.merged_rules(fm))
    if jshape.kind == "train":
        params = model.abstract(jnp.float32)
        state = (_shard_bytes(params, model.axes(), JShardCtx(
            fm, jrules.param_rules(fm, zero3=jcfg.zero3)))
            + 2 * _shard_bytes(params, model.axes(), JShardCtx(
                fm, jrules.opt_rules(fm)),
                jnp.dtype(jcfg.opt_moment_dtype).itemsize))
        inputs = _shard_bytes(jspecs.train_batch_specs(jcfg, jshape),
                              jspecs.train_batch_axes(jcfg), act)
        return state + 4 + inputs, state       # + the int32 step
    params = model.abstract(jnp.bfloat16)
    state = _shard_bytes(params, model.axes(),
                         JShardCtx(fm, jrules.param_rules(fm)))
    if jshape.kind == "prefill":
        inputs = _shard_bytes(jspecs.prefill_specs(jcfg, jshape),
                              jspecs.prefill_axes(jcfg), act)
    else:
        d = jspecs.decode_specs(jcfg, jshape, model)
        inputs = (_shard_bytes(d["cache"], model.cache_axes(), act)
                  + _shard_bytes({k: d[k] for k in ("tokens", "positions")},
                                 jspecs.decode_axes(jcfg), act))
    return state + inputs, state


@pytest.mark.parametrize("arch,shape,mesh", CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in CELLS])
def test_argument_bytes_equal_the_reference_shards(dry, arch, shape, mesh):
    got = dry["arguments"][f"{arch}/{shape}/{mesh}"]
    arguments, state = _reference_arguments(arch, shape, mesh)
    assert got == dict(arguments=arguments, state=state)


# -- depth ---------------------------------------------------------------

@pytest.mark.parametrize("case", DEPTH)
def test_extrapolation_equals_an_uncut_run(dry, case):
    """A train step run with 1 and 2 of its microbatches, a prefill or a
    decode step at two shorter depths, extrapolated: every count equal
    to the uncut run's."""
    rec = dry["depth"][case]
    ext, full = rec["extrapolated"], rec["full"]
    n = full["depth_run"][0]
    if case.endswith("train_4k"):
        assert ext["accum_run"] == [1, 2] and ext["depth_run"] == [n]
        assert full["accum_run"] == [cells.TRAIN_ACCUM]
        assert ext["reduced"] == "microbatches, extrapolated exactly"
    elif "full_depth" in ext:       # its peak did not grow as its cache
        assert ext["depth_run"] == [n] and "reduced" not in ext
        assert "persistent outputs" in ext["full_depth"]
    else:
        assert len(ext["depth_run"]) == 2 and max(ext["depth_run"]) < n
        assert ext["reduced"] == "depth, extrapolated exactly"
    for key in ("memory", "cost", "collectives"):
        assert ext[key] == full[key], key
    assert full["cost"]["flops"] > 0 and full["memory"]["temp_size_in_bytes"]
    assert (full["collectives"]["total_link_bytes"] > 0) == ("/1/" not in case)


def test_most_serving_cases_extrapolate(dry):
    """The full-depth fallback is the exception: at the smoke sizes a
    vocab-sized embedding can outweigh a tiny cache at both cut depths
    (musicgen's prefill), elsewhere the prefill and decode steps run
    cut."""
    cut = [k for k, r in dry["depth"].items() if not k.endswith("train_4k")
           and r["extrapolated"].get("reduced")]
    assert len(cut) >= 2 * len(cells.DEPTH_CASES) - 2, cut


def test_full_width_decode_cell_materialises_nothing(dry):
    """llama3-8b ``decode_32k`` on 16 x 16 at full width and depth (its
    rank's cache alone is 2 GiB): the subprocess's peak RSS grows by
    under 1 GB, and the extrapolated record equals it."""
    full, ext = dry["full"]["record"], dry["full"]["extrapolated"]
    assert dry["full"]["rss_growth_bytes"] < RSS_LIMIT
    assert full["depth_run"] == [32] and ext["depth_run"] == [2, 3]
    assert full["memory"]["argument_size_in_bytes"] > 3 * RSS_LIMIT
    for key in ("memory", "cost", "collectives"):
        assert ext[key] == full[key], key
    assert ext["fits"] and ext["mesh"] == "16x16"


# -- records ---------------------------------------------------------------

def test_skip_and_error_records(dry):
    skip, error = dry["cells"]["skip"], dry["cells"]["error"]
    assert skip["mesh"] == "16x16" and "sub-quadratic" in skip["skipped"]
    assert "memory" not in skip
    assert error["mesh"] == "2x16x16"
    assert error["error"] == "ValueError: a config that cannot be built"
    assert "Traceback" in error["traceback"]

"""The port's sharding context (``repro_torch.models.base.ShardCtx``,
``repro_torch.sharding.layout.Sharding``) against the reference's
``repro.models.base.ShardCtx`` and ``NamedSharding``, on the CPU with no
process group.

(a) The reference's rule tests (``tests/test_sharding.py``): divisible
axes shard, an indivisible one falls back, a mesh axis is used once, a
batch of one is whole, the null ctx is a no-op.  (b) ``spec`` equals the
reference's on every leaf of the ten configs' full-size declarations,
under ``param_rules`` (ZeRO-3 off and on), ``opt_rules`` and
``merged_rules``, on (16, 16), (2, 16, 16) with a pod axis, (2, 2) and
(1, 4) meshes, and on the train batch's axes.  (c) One subprocess on 8
forced host devices gives the reference's ``devices_indices_map`` of a
handful of leaves (one split over ("pod", "data")); each rank's block
under the port's ``Sharding`` (``bounds``, and ``place`` on an arange)
is that index range at the same mesh coordinate.
"""
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.models import build as jbuild
from repro.models.base import NULL_CTX as JNULL_CTX
from repro.models.base import ShardCtx as JShardCtx
from repro.sharding import rules as jrules
from repro_torch import configs as tconfigs
from repro_torch.launch.specs import train_batch_axes
from repro_torch.models import NULL_CTX, ShardCtx, build
from repro_torch.models.base import leaves
from repro_torch.sharding import rules
from repro_torch.sharding.layout import Sharding

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


class FakeMesh:
    """Quacks enough like a mesh for ``spec`` (axis sizes)."""
    def __init__(self, **axes):
        self.shape = dict(axes)


def _rules():
    return {"batch": ("pod", "data"), "heads": "model", "kv": "model",
            "head_dim": "model", "mlp": "model", "experts": "model",
            "vocab": "model", "layers": None}


# -- (a) the reference's rule tests ----------------------------------------

RULE_CASES = {
    "divisible-heads": (dict(pod=2, data=16, model=16), {},
                        (4096, 32, 128), ("embed", "heads", None),
                        (None, "model", None)),
    "divisible-batch": (dict(pod=2, data=16, model=16), {},
                        (256, 4096), ("batch", None),
                        (("pod", "data"), None)),
    "indivisible-kv-to-head-dim": (dict(data=16, model=16), {},
                                   (128, 32768, 2, 128),
                                   ("batch", None, "kv", "head_dim"),
                                   (("pod", "data"), None, None, "model")),
    "axis-used-once": (dict(data=16, model=16), dict(moe_mlp="model"),
                       (64, 2048, 1408), ("experts", "embed", "moe_mlp"),
                       ("model", None, None)),
    "axis-to-the-next-dim": (dict(data=16, model=16), dict(moe_mlp="model"),
                             (8, 6144, 32768),
                             ("experts", "embed", "moe_mlp"),
                             (None, None, "model")),
    "batch-one-whole": (dict(data=16, model=16), {}, (1, 524288),
                        ("batch", None), (None, None)),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_rule(case):
    axes, extra, shape, names, want = RULE_CASES[case]
    mesh, table = FakeMesh(**axes), dict(_rules(), **extra)
    got = ShardCtx(mesh, table).spec(shape, names)
    assert got == want
    assert got == tuple(JShardCtx(mesh, table).spec(shape, names))


def test_null_ctx_noop():
    x = torch.zeros((4, 4))
    assert NULL_CTX.constrain(x, "batch", None) is x
    assert NULL_CTX.spec((4, 4), ("batch", None)) == () == tuple(
        JNULL_CTX.spec((4, 4), ("batch", None)))
    assert NULL_CTX.sharding((4, 4), ("batch", None)) is None
    assert build(tconfigs.get_config("llama3-8b").smoke(),
                 device="meta").ctx is NULL_CTX


def test_sharding_placements_and_shapes():
    """A dim over ("pod", "data") is ``Shard`` on both mesh dims; the
    shard and full shapes invert each other."""
    from torch.distributed.tensor import Replicate, Shard
    s = Sharding(FakeMesh(pod=2, data=4, model=2),
                 (("pod", "data"), None, "model"))
    assert s.placements == (Shard(0), Shard(0), Shard(2))
    assert s.replicated_axes == ()
    assert s.shard_shape((16, 3, 8)) == (2, 3, 4)
    assert s.full_shape((2, 3, 4)) == (16, 3, 8)
    r = Sharding(FakeMesh(data=2, model=2), ("model", None))
    assert r.placements == (Replicate(), Shard(0))
    assert r.replicated_axes == ("data",)


# -- (b) the ten configs ----------------------------------------------------

MESHES = {"16x16": dict(data=16, model=16),
          "pod-2x16x16": dict(pod=2, data=16, model=16),
          "2x2": dict(data=2, model=2), "1x4": dict(data=1, model=4)}
TABLES = {"param": ("param_rules", {}),
          "param-zero3": ("param_rules", dict(zero3=True)),
          "opt": ("opt_rules", {}), "merged": ("merged_rules", {})}


@pytest.fixture(scope="module")
def decls():
    """name -> (the port's full-size declarations, the reference's)."""
    return {name: (build(tconfigs.get_config(name), device="meta").decls(),
                   jbuild(jconfigs.get_config(name)).decls())
            for name in jconfigs.ARCH_IDS}


@pytest.mark.parametrize("table", list(TABLES))
@pytest.mark.parametrize("name", jconfigs.ARCH_IDS)
def test_specs_equal_reference_on_every_leaf(decls, name, table):
    fn, kw = TABLES[table]
    ours, theirs = decls[name]
    want = dict(leaves(theirs))
    got = dict(leaves(ours))
    assert got.keys() == want.keys()
    for axes in MESHES.values():
        mesh = FakeMesh(**axes)
        ctx = ShardCtx(mesh, getattr(rules, fn)(mesh, **kw))
        jctx = JShardCtx(mesh, getattr(jrules, fn)(mesh, **kw))
        for path, p in got.items():
            q = want[path]
            assert (p.shape, p.axes) == (q.shape, q.axes), path
            assert ctx.spec(p.shape, p.axes) == tuple(
                jctx.spec(q.shape, q.axes)), (axes, path)
        shardings = ctx.param_shardings(ours)
        for path, s in leaves(shardings):
            assert s.spec == ctx.spec(got[path].shape, got[path].axes)


@pytest.mark.parametrize("name", jconfigs.ARCH_IDS)
def test_train_batch_axes_equal_reference(name):
    """``train_batch_axes`` is the reference's, and so is the batch's
    spec under ``merged_rules`` at a global batch that splits and one
    that does not."""
    cfg = jconfigs.get_config(name)
    axes = train_batch_axes(tconfigs.get_config(name))
    assert axes == jspecs.train_batch_axes(cfg)
    for m in MESHES.values():
        mesh = FakeMesh(**m)
        ctx = ShardCtx(mesh, rules.merged_rules(mesh))
        jctx = JShardCtx(mesh, jrules.merged_rules(mesh))
        for batch in (64, 3):
            for k, a in axes.items():
                shape = tuple(batch if x == "batch" else 2 for x in a)
                assert ctx.spec(shape, a) == tuple(jctx.spec(shape, a))


# -- (c) blocks against the reference's devices_indices_map -----------------

DEVICE_MESHES = {"2x2": ((2, 2), ("data", "model")),
                 "1x4": ((1, 4), ("data", "model")),
                 "2x4": ((2, 4), ("data", "model")),
                 "pod-2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# (declaration leaf of llama3-8b or None for the train batch, table)
LEAVES = [(("embed",), "opt"), (("lm_head",), "param"),
          (("layers", "attn", "wq"), "param-zero3"),
          (("layers", "mlp", "w_down"), "opt"),
          (("layers", "attn", "wk"), "opt"),
          (("final_norm", "gamma"), "opt"), (None, "merged")]

REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    cases = json.load(open(sys.argv[1]))
    devs = np.array(jax.devices())
    out = []
    for c in cases:
        shape = tuple(c["mesh"])
        grid = devs[:int(np.prod(shape))].reshape(shape)
        mesh = Mesh(grid, tuple(c["names"]))
        spec = PartitionSpec(*[tuple(e) if isinstance(e, list) else e
                               for e in c["spec"]])
        idx = NamedSharding(mesh, spec).devices_indices_map(
            tuple(c["shape"]))
        blocks = []
        for coord in np.ndindex(*shape):
            sl = idx[grid[coord]]
            blocks.append([list(coord), [[s.start or 0,
                                          n if s.stop is None else s.stop]
                                         for s, n in zip(sl, c["shape"])]])
        out.append(blocks)
    print("REF_OK", json.dumps(out))
""")


def _leaf_cases(full: bool):
    """(mesh name, shape, spec) of each leaf of LEAVES on each mesh; at
    full size, or the smoke config's (small enough to ``place``)."""
    cfg = tconfigs.get_config("llama3-8b")
    cfg = cfg if full else cfg.smoke()
    decls = build(cfg, device="meta").decls()
    out = []
    for mname, (shape, names) in DEVICE_MESHES.items():
        mesh = FakeMesh(**dict(zip(names, shape)))
        for path, table in LEAVES:
            fn, kw = TABLES[table]
            ctx = ShardCtx(mesh, getattr(rules, fn)(mesh, **kw))
            if path is None:
                axes = train_batch_axes(cfg)["tokens"]
                leaf_shape = (2, 16, 64)
            else:
                p = decls
                for k in path:
                    p = p[k]
                leaf_shape, axes = p.shape, p.axes
            out.append((mname, leaf_shape, ctx.spec(leaf_shape, axes)))
    return out


@pytest.fixture(scope="module")
def indices(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_ctx")
    cases = _leaf_cases(True) + _leaf_cases(False)
    (tmp / "cases.json").write_text(json.dumps([
        dict(mesh=DEVICE_MESHES[m][0], names=DEVICE_MESHES[m][1],
             shape=shape, spec=[list(e) if isinstance(e, tuple) else e
                                for e in spec])
        for m, shape, spec in cases]))
    # JAX_PLATFORMS=cpu matters: see tests/test_crossbar_sharding.py.
    r = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(tmp / "cases.json")],
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             "HOME": os.path.expanduser("~"), "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=300)
    assert "REF_OK" in r.stdout, (r.stdout[-2000:], r.stderr[-3000:])
    blocks = json.loads(r.stdout.split("REF_OK", 1)[1])
    return list(zip(cases, blocks))


@pytest.mark.parametrize("mname", list(DEVICE_MESHES))
def test_blocks_equal_devices_indices_map(indices, mname):
    """Every leaf, every mesh coordinate: ``bounds`` is the reference's
    index range; at the smoke size ``place`` cuts exactly that block."""
    seen_pod = False
    for (m, shape, spec), blocks in indices:
        if m != mname:
            continue
        s = Sharding(FakeMesh(**dict(zip(*DEVICE_MESHES[m][::-1]))), spec)
        small = math.prod(shape) <= 1 << 20
        x = torch.arange(math.prod(shape)).reshape(shape) if small else None
        for coord, want in blocks:
            got = s.bounds(shape, tuple(coord))
            assert [list(b) for b in got] == want, (shape, spec, coord)
            if small:
                block = s.place(x, coord=tuple(coord))
                ref = x[tuple(slice(a, b) for a, b in want)]
                assert block.is_contiguous() and torch.equal(block, ref)
        seen_pod |= ("pod", "data") in spec
    assert seen_pod == (mname == "pod-2x2x2")


def test_every_coordinate_is_covered_once(indices):
    """Over the ranks that do not replicate a leaf, the blocks tile it:
    each element lies in exactly one."""
    for (m, shape, spec), blocks in indices:
        if math.prod(shape) > 1 << 20:
            continue
        s = Sharding(FakeMesh(**dict(zip(*DEVICE_MESHES[m][::-1]))), spec)
        hits = np.zeros(shape, np.int64)
        for coord, _ in blocks:
            at = dict(zip(s.sizes, coord))
            if any(at[a] for a in s.replicated_axes):
                continue
            hits[tuple(slice(a, b) for a, b in s.bounds(shape, coord))] += 1
        assert (hits == 1).all(), (m, shape, spec)

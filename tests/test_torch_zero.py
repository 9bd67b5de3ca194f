"""The port's ZeRO training on a mesh (``repro_torch.train``:
``make_train_step(..., grad_shardings=, param_shardings=)``,
``apply_updates`` on shards, ``CheckpointManager(shardings=)``,
``TrainLoop(state_shardings=)``) in one gloo world of 4 on the CPU, held
to the reference's one-device training and to the port's own.

A module fixture writes the numpy inputs (the reference's smoke
parameters of llama3-8b and deepseek-v2-lite-16b in f32, their constant
leaves drawn as in ``tests/test_torch_train_step.py``; 2 microbatches of
4 x 32 tokens) and spawns the world (``launch.mesh.spawn``, file
rendezvous; the rank program is ``tests/_torch_zero_ranks.py``), which
builds the (2, 2) and (1, 4) meshes; meanwhile this process runs the
reference's gradients and train step.

Bounds: those of ``tests/test_torch_train_step.py`` in f32.  Loss rtol
1e-5 against the port's one-device step, and no further from the
reference's than that step is, plus 1e-5 (on these batches the port's
one-device loss is itself 1.8e-5 from the reference's on one
microbatch, and moves 1.2e-5 under a one-ulp nudge of its parameters);
each leaf's gathered gradient within 1e-2 in relative Frobenius norm
(the one-ulp sensitivity of the attention models' f32 gradients sets
it; the sharded sums run in another order than one device's); the grad
norm within the same 1e-2.  After one step Adam moves each element
by lr x the sign of its gradient, so an element whose gradient sits at
the noise level may move the other way: no parameter may differ by more
than 2 lr (+ 1e-6 of the element), the update keeps a cosine of 0.99
over the tree and 0.9 in each leaf, m is held at 1e-2 and v (a square)
at 2e-2.  Shards that the mesh
replicates are equal bit for bit across the ranks that hold them, and so
are the metrics; a batch that does not divide the data axis is whole on
every data rank and gives bit for bit the gradient that one data group
computes alone (tensor parallel on its model axis, nothing over the
data axis), and the port's one-device gradients within the bounds (the
model axis's partial sums add in another order than one device's);
checkpoints cross one device, both meshes and the reference bit for
bit.

The MoE load-balance loss is taken per data shard (``_torch_zero_ranks
.SPLIT``), as the reference's expert-parallel path takes it on a mesh, so
deepseek on (2, 2) is held to the one-device gradient of its two row
slices' mean loss.
"""
import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.train import AdamWConfig as JAdamW
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import init_state as jinit_state
from repro.train import make_train_step as jmake_train_step
from repro.train.optimizer import apply_updates as japply_updates
from repro.train.step import cast_tree as jcast_tree
from repro_torch.launch.mesh import spawn
from repro_torch.models import ShardCtx, build
from repro_torch.models.base import leaves
from repro_torch.sharding.rules import opt_rules, param_rules

import _torch_zero_ranks as ranks
from test_torch_train_step import _draw_constants, _np, _rel_frob

WORLD = 4
LOSS_RTOL, FROB, V_FROB, UPDATE_COS, LEAF_COS = 1e-5, 1e-2, 2e-2, 0.99, 0.9
CASES = [(n, s) for n in ranks.CONFIGS for s in ranks.MESHES]
IDS = [f"{n}-{ranks.mesh_tag(s)}" for n, s in CASES]


class FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)


def _reference(name, tree, tokens, shards, out, step=True):
    """The reference's one-device loss and gradient (the mean over the
    microbatches and ``shards`` row slices) and, with ``step``, its state
    after one step: its jitted train step for one slice, its
    ``apply_updates`` on that gradient else."""
    jcfg = dataclasses.replace(jconfigs.get_config(name).smoke(),
                               dtype="float32")
    model = jbuild(jcfg)
    f = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss(jcast_tree(p, jcfg.dtype), b)[0]))
    rows = tokens.shape[1] // shards
    runs = [f(tree, {"tokens": jnp.asarray(tokens[i, j * rows:
                                                 (j + 1) * rows])})
            for i in range(tokens.shape[0]) for j in range(shards)]
    grads = jax.tree.map(lambda *g: sum(g) / len(g), *[g for _, g in runs])
    tag = ranks.one_tag(name, tokens.shape[1], shards)
    out[f"{tag}/loss"] = np.mean([float(x) for x, _ in runs])
    for path, g in leaves(_np(grads)):
        out[f"{tag}/grads/{ranks.key(path)}"] = g
    if not step:
        return
    opt = JAdamW(**ranks.OPT)
    state = jinit_state(jax.tree.map(jnp.asarray, tree), opt)
    if shards == 1:
        state, metrics = jax.jit(jmake_train_step(model, opt))(
            state, {"tokens": jnp.asarray(tokens)}, 0)
    else:
        state, metrics = jax.jit(lambda s, g: japply_updates(s, g, opt))(
            state, grads)
    out[f"{tag}/grad_norm"] = float(metrics["grad_norm"])
    for part in ("params", "m", "v"):
        for path, t in leaves(_np(getattr(state, part))):
            out[f"{tag}/{part}/{ranks.key(path)}"] = t


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the world (in a thread) while this process runs the
    reference; -> (reference results, [each rank's results], tmp)."""
    tmp = tmp_path_factory.mktemp("zero")
    rng = np.random.default_rng(0)
    arrays, trees = {}, {}
    for name in ranks.CONFIGS:
        cfg = jconfigs.get_config(name).smoke()
        trees[name] = _draw_constants(_np(jbuild(cfg).init(
            jax.random.key(0))))
        for path, a in leaves(trees[name]):
            arrays[f"{name}/tree/{ranks.key(path)}"] = a
        arrays[f"{name}/tokens"] = rng.integers(
            0, cfg.vocab, (ranks.ACCUM, ranks.B, ranks.S)).astype(np.int32)
    name = ranks.CONFIGS[0]
    arrays[f"{name}/tokens_odd"] = rng.integers(
        0, jconfigs.get_config(name).smoke().vocab,
        (ranks.ACCUM, ranks.B_ODD, ranks.S)).astype(np.int32)
    np.savez(tmp / "inputs.npz", **arrays)

    failed = []

    def run():
        try:
            spawn(ranks.zero_main, WORLD, str(tmp),
                  init_method=f"file://{tmp}/store")
        except BaseException as e:     # re-raised on the test's thread
            failed.append(e)
    thread = threading.Thread(target=run)
    thread.start()
    ref = {}
    try:
        for name in ranks.CONFIGS:
            _reference(name, trees[name], arrays[f"{name}/tokens"], 1, ref)
        for (name, _), shards in ranks.SPLIT.items():
            _reference(name, trees[name], arrays[f"{name}/tokens"], shards,
                       ref)
        name = ranks.CONFIGS[0]
        _reference(name, trees[name], arrays[f"{name}/tokens_odd"], 1, ref,
                   step=False)
    finally:
        thread.join()
    if failed:
        raise failed[0]
    return (ref, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)],
            tmp)


def _one(name, shape, batch=ranks.B):
    return ranks.one_tag(name, batch, ranks.SPLIT.get((name, shape), 1))


def _wants(world, name, shape, batch=ranks.B):
    """[(label, results, tag)] of the two one-device references."""
    ref, out, _ = world
    tag = _one(name, shape, batch)
    return [("reference", ref, tag), ("port", out[0], tag)]


def _leaf_keys(res: dict, prefix: str) -> list[str]:
    return sorted(k[len(prefix) + 1:] for k in res if k.startswith(prefix
                                                                  + "/"))


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_loss_and_grad_norm_match_one_device(world, name, shape):
    """The loss within rtol 1e-5 of the port's one-device loss, and no
    further from the reference's than that one is, plus 1e-5; the grad
    norm within 1e-2 of both; the learning rate equal."""
    ref, out, _ = world
    got = out[0]
    tag = f"{name}/{ranks.mesh_tag(shape)}"
    one = _one(name, shape)
    port, want = float(out[0][f"{one}/loss"]), float(ref[f"{one}/loss"])
    for loss in (got[f"{tag}/metric/loss"], got[f"{tag}/grads_loss"]):
        assert abs(loss - port) <= LOSS_RTOL * abs(port), (loss, port)
        assert abs(loss - want) <= abs(port - want) + LOSS_RTOL * abs(
            want), (loss, want, port)
    for label, res, w in _wants(world, name, shape):
        gn, gw = got[f"{tag}/metric/grad_norm"], res[f"{w}/grad_norm"]
        assert abs(gn - gw) <= FROB * abs(gw), (label, gn, gw)
    assert got[f"{tag}/metric/lr"] == np.float32(ranks.OPT["lr"])


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_gathered_grads_match_one_device(world, name, shape):
    got = world[1][0]
    tag = f"{name}/{ranks.mesh_tag(shape)}/grads"
    keys = _leaf_keys(got, tag)
    for label, res, want in _wants(world, name, shape):
        assert keys == _leaf_keys(res, f"{want}/grads"), label
        for k in keys:
            g, w = got[f"{tag}/{k}"], res[f"{want}/grads/{k}"]
            assert g.shape == w.shape, (label, k)
            rel = _rel_frob(g, w)
            assert rel <= FROB, f"{label} {k}: rel Frobenius {rel:.2e}"


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_one_step_matches_one_device(world, name, shape):
    got = world[1][0]
    tag = f"{name}/{ranks.mesh_tag(shape)}"
    lr = ranks.OPT["lr"]
    for label, res, want in _wants(world, name, shape):
        for k in _leaf_keys(got, f"{tag}/params"):
            p, w = got[f"{tag}/params/{k}"], res[f"{want}/params/{k}"]
            gap = np.abs(p - w) / (2 * lr + 1e-6 * np.abs(w))
            assert gap.max() <= 1.0, f"{label} {k}: {gap.max():.3f} x 2 lr"
            m, mw = got[f"{tag}/m/{k}"], res[f"{want}/m/{k}"]
            assert _rel_frob(m, mw) <= FROB, (label, "m", k)
            v, vw = got[f"{tag}/v/{k}"], res[f"{want}/v/{k}"]
            assert _rel_frob(v, vw) <= V_FROB, (label, "v", k)


def _cos(a, b) -> float:
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b),
                             1e-300))


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_one_step_update_direction(world, name, shape):
    """The update (step minus start) keeps a cosine of 0.99 with the
    one-device step's over the whole tree, and of 0.9 in each leaf: a
    norm scale of 64 elements with one element's gradient at the noise
    level, which Adam's first step then moves the other way, comes to
    0.969, a leaf whose gradient were read from the wrong place to about
    0."""
    _, out, tmp = world
    start = dict(np.load(tmp / "inputs.npz"))
    got = out[0]
    tag = f"{name}/{ranks.mesh_tag(shape)}"
    for label, res, want in _wants(world, name, shape):
        ups = []
        for k in _leaf_keys(got, f"{tag}/params"):
            w0 = start[f"{name}/tree/{k}"].astype(np.float64).ravel()
            a = got[f"{tag}/params/{k}"].ravel() - w0
            b = res[f"{want}/params/{k}"].ravel() - w0
            assert _cos(a, b) >= LEAF_COS, f"{label} {k}: {_cos(a, b):.4f}"
            ups.append((a, b))
        cos = _cos(*(np.concatenate(x) for x in zip(*ups)))
        assert cos >= UPDATE_COS, f"{label}: tree cosine {cos:.4f}"


def _specs(name, shape):
    """{part: {leaf key: Sharding}} over a FakeMesh: parameters by
    ``param_rules``, moments and gradients by ``opt_rules``."""
    cfg = ranks.config(name)
    mesh = FakeMesh(data=shape[0], model=shape[1])
    decls = build(cfg, device="meta").decls()
    p = ShardCtx(mesh, param_rules(mesh, zero3=cfg.zero3)).param_shardings(
        decls)
    o = ShardCtx(mesh, opt_rules(mesh)).param_shardings(decls)
    full = {ranks.key(k): d.shape for k, d in leaves(decls)}
    sh = {part: {ranks.key(k): s for k, s in leaves(t)}
          for part, t in (("params", p), ("m", o), ("v", o), ("grads", o))}
    return sh, full


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_local_shards_have_the_spec_shapes(world, name, shape):
    """Every rank holds only its shard of each leaf: the shape the spec
    gives, and some leaves are split over each mesh axis larger than
    one."""
    sh, full = _specs(name, shape)
    tag = f"{name}/{ranks.mesh_tag(shape)}/local"
    split = set()
    for out in world[1]:
        for part, specs in sh.items():
            for k, s in specs.items():
                local = out[f"{tag}/{part}/{k}"]
                assert local.shape == s.shard_shape(full[k]), (part, k)
                if local.size < np.prod(full[k]):
                    split.update(a for e in s.spec for a in (
                        e if isinstance(e, tuple) else (e,))
                        if a and s.sizes[a] > 1)
    assert split == {a for a, n in zip(("data", "model"), shape) if n > 1}


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_replicated_shards_are_bitwise_equal(world, name, shape):
    """Ranks that hold the same shard (the same index on every axis that
    splits the leaf) hold the same bits; the metrics are the same bits on
    every rank."""
    sh, _ = _specs(name, shape)
    mt = ranks.mesh_tag(shape)
    i = ranks.MESHES.index(shape)
    outs = world[1]
    for k in ("loss", "grad_norm", "lr"):
        assert len({float(o[f"{name}/{mt}/metric/{k}"]) for o in outs}) == 1
    pairs = 0
    for part, specs in sh.items():
        for k, s in specs.items():
            held = {}
            for out in outs:
                at = dict(zip(("data", "model"), out["coordinate"][i]))
                mine = tuple(at[a] for a in ("data", "model")
                             if a not in s.replicated_axes)
                local = out[f"{name}/{mt}/local/{part}/{k}"]
                if mine in held:
                    np.testing.assert_array_equal(local, held[mine],
                                                  err_msg=f"{part} {k}")
                    pairs += 1
                held.setdefault(mine, local)
    assert pairs > 0


def test_kv_falls_back_to_head_dim_on_1x4():
    """On a model axis of 4, llama3's smoke kv = 2 heads do not divide it:
    a kv cache's ``head_dim`` takes the axis, and ``wk`` / ``wv``, which
    have no ``head_dim`` axis, are whole on every rank (the reference's
    specs)."""
    from repro.models.base import ShardCtx as JShardCtx
    cfg = ranks.config("llama3-8b")
    mesh = FakeMesh(data=1, model=4)
    rules = param_rules(mesh)
    cache = ((2, 64, cfg.n_kv_heads, cfg.resolved_head_dim),
             ("batch", None, "kv", "head_dim"))
    wk = build(cfg, device="meta").decls()["layers"]["attn"]["wk"]
    for shape, axes, want in (cache + ((("data", None, None, "model"),)),
                              (wk.shape, wk.axes, (None,) * 4)):
        spec = ShardCtx(mesh, rules).spec(shape, axes)
        assert spec == want == tuple(JShardCtx(mesh, rules).spec(shape,
                                                                 axes))


def test_kv_weights_are_whole_on_1x4(world):
    """On (1, 4) every rank holds all of ``wk``, the same bits."""
    cfg = ranks.config("llama3-8b")
    full = build(cfg, device="meta").decls()["layers"]["attn"]["wk"].shape
    outs = world[1]
    wk = [o["llama3-8b/1x4/local/params/layers/attn/wk"] for o in outs]
    for w in wk:
        assert w.shape == full
        np.testing.assert_array_equal(w, wk[0])


def test_indivisible_batch_gives_one_device_grads(world):
    """A batch of 3 rows on a data axis of 2 is whole on every data rank:
    the ZeRO step's gradient is bit for bit the one that each data group
    computes alone (the same step with the gradients laid out over the
    model axis only: nothing crosses the data axis), every data rank
    holds the same bits of it and of the loss, and it is the port's
    one-device gradient and the reference's within the bounds (tensor
    parallel over the model axis, the sums run in another order than
    one device's)."""
    ref, out, _ = world
    name = ranks.CONFIGS[0]
    got = out[0]
    odd, group = f"odd/{name}", f"odd/{name}/group"
    keys = _leaf_keys(got, f"{odd}/grads")
    tag = ranks.one_tag(name, ranks.B_ODD)
    assert keys and keys == _leaf_keys(out[0], f"{tag}/grads")
    assert keys == _leaf_keys(got, f"{group}/grads")
    for k in keys:
        np.testing.assert_array_equal(got[f"{odd}/grads/{k}"],
                                      got[f"{group}/grads/{k}"], err_msg=k)
        for want in (out[0][f"{tag}/grads/{k}"], ref[f"{tag}/grads/{k}"]):
            rel = _rel_frob(got[f"{odd}/grads/{k}"], want)
            assert rel <= FROB, f"{k}: rel Frobenius {rel:.2e}"
    by_model: dict = {}
    for o in out:              # the (2, 2) mesh's model coordinate
        by_model.setdefault(int(o["coordinate"][0][1]), []).append(o)
    assert sorted(len(v) for v in by_model.values()) == [2, 2]
    local = _leaf_keys(got, f"{group}/local/grads")
    assert local
    for a, b in by_model.values():
        for k in local:
            np.testing.assert_array_equal(a[f"{group}/local/grads/{k}"],
                                          b[f"{group}/local/grads/{k}"],
                                          err_msg=k)
    loss = got[f"{odd}/grads_loss"]
    assert len({float(o[p]) for o in out for p in (
        f"{odd}/grads_loss", f"{group}/grads_loss")}) == 1
    for want in (out[0][f"{tag}/loss"], ref[f"{tag}/loss"]):
        assert abs(loss - want) <= LOSS_RTOL * abs(loss)


@pytest.mark.parametrize("where", ["one", "m14", "m22"])
def test_checkpoint_restores_across_topologies(world, where):
    """Saved on (2, 2): restored on one device, on (1, 4) and back on
    (2, 2), every leaf bit for bit on every rank."""
    for out in world[1]:
        assert bool(out[f"ckpt/{where}_equal"]), out.get("ckpt/one_step")


def test_checkpoint_restores_in_the_reference(world):
    """The reference's ``CheckpointManager`` reads the files of the (2, 2)
    save: each leaf is the gathered state's, bit for bit."""
    _, out, tmp = world
    name = ranks.CONFIGS[0]
    jcfg = dataclasses.replace(jconfigs.get_config(name).smoke(),
                               dtype="float32")
    template = jinit_state(jbuild(jcfg).init(jax.random.key(0)), JAdamW())
    state, step = JCheckpointManager(tmp / "ckpt").restore(template)
    assert step == 1 and int(state.step) == 1
    for part in ("params", "m", "v"):
        for path, t in leaves(_np(getattr(state, part))):
            np.testing.assert_array_equal(
                t, out[0][f"ckpt/{part}/{ranks.key(path)}"],
                err_msg=f"{part} {path}")


def test_trainloop_resumes_bitwise_on_every_rank(world):
    """Failing at step 5 with step 3 published, the resumed loop gives the
    uninterrupted run's losses and final state bit for bit on every rank;
    rank 0 wrote the heartbeat."""
    _, outs, tmp = world
    for out in outs:
        assert bool(out["loop/raised"])
        assert int(out["loop/published"]) == ranks.LOOP_SAVE
        ref = out["loop/ref_losses"]
        assert len(ref) == ranks.LOOP_STEPS and ref[-1] < ref[0]
        np.testing.assert_array_equal(out["loop/resumed_losses"],
                                      ref[ranks.LOOP_SAVE:])
        assert bool(out["loop/final_equal"])
        np.testing.assert_array_equal(ref, outs[0]["loop/ref_losses"])
    hb = json.loads((tmp / "ft" / "HEARTBEAT").read_text())
    assert hb["step"] == ranks.LOOP_STEPS


def test_straggler_on_one_rank_does_not_deadlock(world):
    """Rank 3 alone sleeps before one step: every rank counts the same
    straggler event (the step time is the slowest rank's) and takes the
    forced save after it, a collective, together."""
    outs = world[1]
    events = {int(o["loop/straggler_events"]) for o in outs}
    assert len(events) == 1 and events.pop() >= 1
    for out in outs:
        assert ranks.STRAGGLER_CALL in set(out["loop/slow_steps"].tolist())


def test_constrain_redistributes_a_dtensor(world):
    """``ShardCtx.constrain`` lays a DTensor out by the activation rules
    (the batch over "data"); a plain tensor comes back as it is."""
    for out in world[1]:
        assert str(out["constrain/placements"]) == \
            "(Shard(dim=0), Replicate())"
        at = int(out["coordinate"][0][0])
        np.testing.assert_array_equal(
            out["constrain/local"],
            np.arange(32.0).reshape(8, 4)[4 * at:4 * (at + 1)])
        assert bool(out["constrain/plain_is_same"])


def test_gloo_rates_on_the_cpu(capfd):
    """``python -m repro_torch.launch.gloo_rates`` on CPU tensors at 1 MB:
    each collective the ZeRO step calls gives its small-tensor result."""
    from repro_torch.launch import gloo_rates
    assert gloo_rates.main(["--device", "cpu", "--mb", "1"]) == 0
    out = capfd.readouterr().out
    assert "cpu all_gather_into_tensor: [0.0, 0.0, 0.0, 0.0, 2.0" in out
    assert "cpu reduce_scatter_tensor: [2.0, 8.0, 14.0, 20.0]" in out
    assert "cpu all_reduce: 2.0" in out
    assert out.count(" s\n") == 6

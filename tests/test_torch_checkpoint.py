"""The port's checkpoints and fault-tolerant loop
(``repro_torch.train.{checkpoint,runtime}``): twins of
``tests/test_checkpoint.py``, and checkpoints that cross between the two
packages leaf for leaf, on the CPU."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.train import AdamWConfig as JAdamW
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import init_state as jinit_state
from repro_torch.configs import get_config
from repro_torch.convert import train_state_arrays, train_state_from_arrays
from repro_torch.models import build
from repro_torch.models.base import leaves
from repro_torch.train import (AdamWConfig, CheckpointManager, RuntimeConfig,
                               SimulatedFailure, TrainLoop, init_state,
                               make_train_step)
from repro_torch.train.checkpoint import leaf_ids


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((16, 8), generator=g),
            "b": {"c": torch.arange(10, dtype=torch.int32),
                  "d": torch.tensor(3.5)}}


def _equal(a, b):
    for (pa, x), (pb, y) in zip(leaves(a), leaves(b)):
        assert pa == pb
        assert x.dtype == y.dtype, pa
        assert torch.equal(x, y), pa


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(7, t)
    restored, step = mgr.restore({"a": torch.zeros(16, 8),
                                  "b": {"c": torch.zeros(10, dtype=torch.int32),
                                        "d": torch.tensor(0.0)}})
    assert step == 7
    _equal(t, restored)


def test_atomic_publish_ignores_partial(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(1, t)
    # Simulate a crash mid-save: stray .tmp directory + torn step dir
    (tmp_path / "step_2.tmp").mkdir()
    torn = tmp_path / "step_3"
    torn.mkdir()
    (torn / "garbage.npy").write_bytes(b"xx")   # no manifest
    assert mgr.latest_step() == 1
    _, step = mgr.restore(t)
    assert step == 1


def test_gc_keeps_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, t)
    assert mgr.steps() == [3, 4]


def test_async_save(tmp_path):
    """The write runs on a thread from a snapshot taken before it starts:
    the caller may update its tensors in place at once (the optimizer
    does) without reaching the checkpoint."""
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    want = {"a": t["a"].clone(), "b": {"c": t["b"]["c"].clone(),
                                       "d": t["b"]["d"].clone()}}
    mgr.save(5, t, blocking=False)
    t["a"].add_(1.0)
    t["b"]["c"].mul_(3)
    mgr.wait()
    assert mgr.latest_step() == 5
    _equal(want, mgr.restore(t)[0])


def _loop(tmp_path, fail_at=None, max_steps=12):
    cfg = get_config("starcoder2-3b").smoke()
    model = build(cfg, device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    state = init_state(model.init(torch.Generator().manual_seed(0)).tree(),
                       opt_cfg)
    step = make_train_step(model, opt_cfg, device="cpu")
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (1, 2, 32))

    def data():
        while True:
            yield {"tokens": tok}

    rt = RuntimeConfig(ckpt_dir=str(tmp_path), max_steps=max_steps,
                       save_every=4, fail_at_step=fail_at,
                       heartbeat_every=4)
    return TrainLoop(step, state, data(), rt, device="cpu")


def test_resume_after_failure_bit_exact(tmp_path):
    # Uninterrupted run -> reference final state.
    ref_loop = _loop(tmp_path / "ref")
    ref = ref_loop.run(seed=0)

    # Crash at step 9 (after the step-8 checkpoint), then resume.
    loop1 = _loop(tmp_path / "ft", fail_at=9)
    with pytest.raises(SimulatedFailure):
        loop1.run(seed=0)
    loop1.mgr.wait()
    assert loop1.mgr.latest_step() == 8

    loop2 = _loop(tmp_path / "ft")          # fresh process, auto-resume
    final = loop2.run(seed=0)
    assert int(final.step) == int(ref.step) == 12
    for part in ("params", "m", "v"):
        _equal(getattr(ref, part), getattr(final, part))
    assert loop2.metrics_log == ref_loop.metrics_log[8:]


def test_heartbeat_written(tmp_path):
    loop = _loop(tmp_path, max_steps=8)
    loop.run(seed=0)
    hb = json.loads((tmp_path / "HEARTBEAT").read_text())
    assert hb["step"] == 8


def test_straggler_detection(tmp_path):
    loop = _loop(tmp_path, max_steps=10)
    events = []
    loop.on_straggler = lambda step, dt: events.append((step, dt))
    # Inject artificial delay into one step via a wrapper: 1.5 s, and ten
    # times the slowest step so far (a loaded host can stretch a CPU step
    # towards the reference's fixed 1.5 s, so the deadline of 3 x the
    # median would no longer tell them apart).
    orig = loop.train_step
    slow = {"n": 0, "max": 0.0}

    def wrapped(state, batch, seed):
        import time
        slow["n"] += 1
        if slow["n"] == 8:
            time.sleep(1.5 + 10 * slow["max"])
        t0 = time.perf_counter()
        out = orig(state, batch, seed)
        slow["max"] = max(slow["max"], time.perf_counter() - t0)
        return out

    loop.train_step = wrapped
    loop.run(seed=0)
    assert loop.straggler_events >= 1
    # The slowed call is step 7's.  Another step may cross the deadline
    # too on a loaded host (the async write of step 4's checkpoint runs
    # beside step 5 on the same cores), so the event is looked up by step.
    assert any(step == 7 and dt > 1.0 for step, dt in events), events


# -- across the two packages -----------------------------------------------

def _ref_state(moments="float32"):
    cfg = jconfigs.get_config("llama3-8b").smoke()
    params = jbuild(cfg).init(jax.random.key(0))
    state = jinit_state(params, JAdamW(moment_dtype=jnp.dtype(moments)))
    # nonzero moments and step, so every leaf carries data
    rng = np.random.default_rng(2)
    bump = lambda a: (a + rng.standard_normal(a.shape)).astype(a.dtype)
    return state.__class__(step=jnp.int32(5), params=state.params,
                           m=jax.tree.map(bump, state.m),
                           v=jax.tree.map(lambda a: jnp.abs(bump(a)),
                                          state.v))


def _template(moments="float32"):
    """The port's state of llama3's smoke model, zeros."""
    model = build(get_config("llama3-8b").smoke(), device="cpu")
    tree = jax.tree.map(torch.zeros_like, model.tree())
    return init_state(tree, AdamWConfig(moment_dtype=getattr(torch,
                                                             moments)))


def test_leaf_ids_are_the_reference_s():
    jstate = _ref_state()
    from repro.train.checkpoint import _flatten as jflatten
    ids = jflatten(jstate)[0]
    assert leaf_ids(_template()) == ids
    assert len(ids) == 37
    assert {"leaf__step", "leaf__params_embed",
            "leaf__params_layers_attn_wq", "leaf__v_lm_head"} <= set(ids)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_port(tmp_path, moments):
    jstate = _ref_state(moments)
    JCheckpointManager(tmp_path).save(5, jstate)
    got, step = CheckpointManager(tmp_path).restore(_template(moments))
    assert step == 5
    want = train_state_from_arrays(jax.tree.map(np.asarray, jstate),
                                   device="cpu")
    assert got.m["embed"].dtype == getattr(torch, moments)
    assert int(got.step) == 5 and got.step.dtype == torch.int32
    for part in ("params", "m", "v"):
        _equal(getattr(want, part), getattr(got, part))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_reference(tmp_path, moments):
    """The port's files are the reference's leaf for leaf: its manager
    restores them (f32), and bf16 leaves hold the bits the reference
    writes (its restore cannot read bf16 back: module doc of
    ``repro_torch.train.checkpoint``)."""
    jstate = _ref_state(moments)
    state = train_state_from_arrays(jax.tree.map(np.asarray, jstate),
                                    device="cpu")
    CheckpointManager(tmp_path / "port").save(5, state)
    JCheckpointManager(tmp_path / "ref").save(5, jstate)
    manifests = [json.loads((tmp_path / d / "step_5" / "manifest.json")
                            .read_text()) for d in ("port", "ref")]
    assert [(e["id"], e["shape"], e["dtype"]) for e in manifests[0]["leaves"]] \
        == [(e["id"], e["shape"], e["dtype"]) for e in manifests[1]["leaves"]]
    for e in manifests[1]["leaves"]:
        a, b = (np.load(tmp_path / d / "step_5" / f"{e['id']}.npy")
                for d in ("port", "ref"))
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), e["id"]
    if moments == "float32":
        restored, step = JCheckpointManager(tmp_path / "port").restore(
            jax.tree.map(jnp.zeros_like, jstate))
        assert step == 5
        for x, y in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    back = train_state_arrays(CheckpointManager(tmp_path / "port")
                              .restore(_template(moments))[0])
    assert int(back["step"]) == 5
    for part in ("params", "m", "v"):
        for x, y in zip(jax.tree.leaves(back[part]),
                        jax.tree.leaves(getattr(jstate, part))):
            np.testing.assert_array_equal(x, np.asarray(y).astype(x.dtype))


def test_restore_checks_the_shardings_tree(tmp_path):
    """``restore(shardings=)`` takes one ``Sharding`` (or None) a leaf of
    the template (``tests/test_torch_zero.py`` restores on meshes); None
    leaves restore whole, as on one device."""
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(2, t)
    with pytest.raises(ValueError, match="3 leaves"):
        mgr.restore(t, shardings={"a": None})
    got, step = mgr.restore(t, shardings={"a": None, "b": {"c": None,
                                                           "d": None}})
    assert step == 2
    _equal(t, got)

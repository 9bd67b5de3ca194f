"""The port's AdamW (``repro_torch.train.optimizer``): twins of
``tests/test_optimizer.py``, and ``apply_updates`` against the
reference's on one random tree, on the CPU.

Against the reference, three steps on the same numpy gradients: the
learning rate and the step are equal bit for bit, and so is a first
step whose gradients are not clipped (parameters and moments, f32 and
bf16).  The global norm (a reduction) and the bias corrections (``b **
step``) round in XLA's own order, an f32 ulp apart: measured over three
steps, 91-98% of the parameters and 20-44% of the f32 moments' elements
bit for bit, the rest within 1.2e-7 absolute; bf16 moments bit for bit.
Bound: rtol 1e-6 (of the element, or of its leaf's largest); bf16
moments one bf16 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import AdamWConfig as JAdamW
from repro.train import apply_updates as japply
from repro.train import init_state as jinit
from repro_torch.convert import _tensor
from repro_torch.models.base import leaves
from repro_torch.train import (AdamWConfig, TrainState, apply_updates,
                               global_norm, init_state)


def test_converges_on_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.0,
                      grad_clip=100.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    state = init_state({"w": torch.zeros(3)}, cfg)
    for _ in range(300):
        g = {"w": 2 * (state.params["w"] - target)}
        state, _ = apply_updates(state, g, cfg)
    np.testing.assert_allclose(state.params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_gradient_clipping():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=1, grad_clip=1.0)
    state = init_state({"w": torch.zeros(4)}, cfg)
    huge = {"w": torch.full((4,), 1e6)}
    state2, metrics = apply_updates(state, huge, cfg)
    assert float(metrics["grad_norm"]) > 1e5
    # update magnitude bounded by lr despite the huge gradient
    assert float(state2.params["w"].abs().max()) < 2 * cfg.lr


def test_moment_dtype_bf16():
    cfg = AdamWConfig(moment_dtype=torch.bfloat16)
    state = init_state({"w": torch.zeros((8, 8))}, cfg)
    assert state.m["w"].dtype == torch.bfloat16
    assert state.v["w"].dtype == torch.bfloat16
    state2, _ = apply_updates(state, {"w": torch.ones((8, 8))}, cfg)
    assert state2.m["w"].dtype == torch.bfloat16
    assert state2.params["w"].dtype == torch.float32   # master stays f32


def test_warmup_schedule():
    cfg = AdamWConfig(lr=1e-2, warmup_steps=10)
    assert float(cfg.schedule(torch.tensor(1))) < 1e-2 * 0.2
    assert np.isclose(float(cfg.schedule(torch.tensor(10))), 1e-2)
    assert np.isclose(float(cfg.schedule(torch.tensor(100))), 1e-2)
    for s in (0, 1, 7, 10, 250):
        assert (np.float32(cfg.schedule(s))
                == np.float32(JAdamW(lr=1e-2, warmup_steps=10)
                              .schedule(jnp.asarray(s))))


def _tree(rng):
    """Leaves of several shapes and scales, a list among the dicts."""
    return {"embed": rng.standard_normal((64, 16)).astype(np.float32),
            "layers": {"w": rng.standard_normal((3, 16, 8)).astype(
                np.float32) * 0.1,
                "gamma": (1 + 0.1 * rng.standard_normal((3, 16))).astype(
                    np.float32)},
            "front": [{"b": rng.standard_normal(5).astype(np.float32)}],
            "scalar": np.float32(0.5)}


@pytest.mark.parametrize("clip_first", [False, True])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(moments, clip_first):
    """Three steps; with ``clip_first`` the first step's gradients are
    clipped (their norm is above ``grad_clip``), else none is.  Without a
    clip the first step is bit for bit the reference's; after it the
    bias corrections' ``pow`` (and with a clip the norm's reduction
    order) differ by an f32 ulp, and each element is held to rtol 1e-6
    of itself or of its leaf's largest (an element that cancels to near
    zero carries its leaf's rounding), bf16 moments to one bf16 ulp."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    kw = dict(lr=3e-2, warmup_steps=2, weight_decay=0.1, grad_clip=1.0)
    jcfg = JAdamW(moment_dtype=jnp.dtype(moments), **kw)
    tcfg = AdamWConfig(moment_dtype=getattr(torch, moments), **kw)
    jstate = jinit(jax.tree.map(jnp.asarray, params), jcfg)
    tstate = init_state(jax.tree.map(lambda a: _tensor(a), params), tcfg)
    for step in range(3):
        scale = 1.0 if clip_first and step == 0 else 0.01
        grads = jax.tree.map(lambda a: (scale * rng.standard_normal(
            np.shape(a))).astype(np.float32), params)
        jstate, jm = japply(jstate, jax.tree.map(jnp.asarray, grads), jcfg)
        tstate, tm = apply_updates(
            tstate, jax.tree.map(lambda a: _tensor(a), grads), tcfg)
        assert isinstance(tstate, TrainState)
        assert int(tstate.step) == int(jstate.step) == step + 1
        assert np.float32(tm["lr"]) == np.float32(jm["lr"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for part in ("params", "m", "v"):
            for (path, t), (_, j) in zip(leaves(getattr(tstate, part)),
                                         leaves(getattr(jstate, part))):
                got = t.float().numpy()
                want = np.asarray(j).astype(np.float32)
                msg = f"step {step} {part} {path}"
                assert t.dtype == (torch.float32 if part == "params"
                                   else tcfg.moment_dtype)
                if step == 0 and not clip_first:
                    np.testing.assert_array_equal(got, want, err_msg=msg)
                elif part != "params" and moments == "bfloat16":
                    ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                        np.abs(want), 1e-30))) - 7)
                    assert np.all(np.abs(got - want) <= ulp), msg
                else:
                    np.testing.assert_allclose(
                        got, want, rtol=1e-6,
                        atol=1e-6 * float(np.abs(want).max()), err_msg=msg)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    want = float(jax.jit(lambda t: jnp.sqrt(sum(
        jnp.sum(jnp.square(x.astype(jnp.float32)))
        for x in jax.tree.leaves(t))))(tree))
    got = float(global_norm(jax.tree.map(lambda a: _tensor(a), tree)))
    np.testing.assert_allclose(got, want, rtol=1e-6)

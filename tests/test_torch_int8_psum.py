"""The port's int8 gradient all-reduce (``repro_torch.train.compression``:
``int8_psum``, ``compressed_grad_allreduce``) in a gloo world of 4 on the
CPU, held bit for bit to the reference's under ``shard_map`` on 4 forced
host devices.

A module fixture writes the numpy inputs, starts the reference in a
subprocess (as ``tests/test_compression.py`` does) and meanwhile spawns
the gloo world (``launch.mesh.spawn``, file rendezvous; the rank program
is ``tests/_torch_train_ranks.py``).  Both quantize with the same f32
divisions and round half to even, and the int8 sums are exact, so every
rank's result and error-feedback residual equal the reference's bit for
bit: a tensor that needs padding for the all_to_all (35 elements over 4
ranks), a tree of two leaves, five steps of error feedback.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.launch.mesh import spawn

import _torch_train_ranks as ranks

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
WORLD, STEPS = 4, 5

REFERENCE = textwrap.dedent("""
    import functools, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map as _shard_map
    from repro.train.compression import (compressed_grad_allreduce,
                                         int8_psum)
    shard_map = functools.partial(_shard_map, check_vma=False)
    tmp = sys.argv[1]
    z = np.load(os.path.join(tmp, "inputs.npz"))
    mesh = Mesh(np.asarray(jax.devices()).reshape(4), ("data",))
    psum = jax.jit(shard_map(lambda v: int8_psum(v[0], "data")[None],
                             mesh=mesh, in_specs=P("data"),
                             out_specs=P("data")))
    out = {"psum": np.asarray(psum(jnp.asarray(z["x"]))),
           "psum_ragged": np.asarray(psum(jnp.asarray(z["ragged"])))}
    step = jax.jit(shard_map(
        lambda g, e: jax.tree.map(
            lambda a: a[None], compressed_grad_allreduce(
                jax.tree.map(lambda a: a[0], g),
                jax.tree.map(lambda a: a[0], e), "data")),
        mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data"))))
    e = {"a": jnp.zeros((4,) + z["ga"].shape[2:]),
         "b": jnp.zeros((4,) + z["gb"].shape[2:])}
    for i in range(z["ga"].shape[0]):
        tot, e = step({"a": jnp.asarray(z["ga"][i]),
                       "b": jnp.asarray(z["gb"][i])}, e)
        for k in ("a", "b"):
            out[f"tot_{k}_{i}"] = np.asarray(tot[k])
            out[f"err_{k}_{i}"] = np.asarray(e[k])
    np.savez(os.path.join(tmp, "ref.npz"), **out)
    print("REF_OK")
""")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("int8")
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    np.savez(tmp / "inputs.npz", x=f32(WORLD, 64, 33),
             ragged=f32(WORLD, 7, 5) * 3,
             ga=f32(STEPS, WORLD, 1, 128) * 0.01,
             gb=f32(STEPS, WORLD, 3, 5) * 0.01)
    # JAX_PLATFORMS=cpu matters: see tests/test_crossbar_sharding.py.
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp)],
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             "HOME": os.path.expanduser("~"), "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        spawn(ranks.int8_main, WORLD, str(tmp),
              init_method=f"file://{tmp}/store")
        out, err = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert "REF_OK" in out, (out[-2000:], err[-3000:])
    inputs = dict(np.load(tmp / "inputs.npz"))
    return (inputs, dict(np.load(tmp / "ref.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)])


@pytest.mark.parametrize("name", ["psum", "psum_ragged"])
def test_int8_psum_bitwise(results, name):
    inputs, ref, ranks_out = results
    x = inputs["x" if name == "psum" else "ragged"]
    want = x.sum(0)
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks_out[r][name], ref[name][r],
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(ranks_out[r][name], ranks_out[0][name])
    rel = np.abs(ranks_out[0][name] - want).max() / np.abs(want).max()
    assert rel < 0.02, rel


@pytest.mark.parametrize("step", range(STEPS))
def test_compressed_grad_allreduce_bitwise(results, step):
    """Totals and error-feedback residuals, every rank, every leaf."""
    _, ref, ranks_out = results
    for k in ("a", "b"):
        for what in ("tot", "err"):
            key = f"{what}_{k}_{step}"
            for r in range(WORLD):
                np.testing.assert_array_equal(
                    ranks_out[r][key], ref[key][r], err_msg=f"{key} rank {r}")


def test_error_feedback_bounds_drift(results):
    """Summed over the steps, the compressed totals stay within 5% of the
    exact sums (the reference test's bound)."""
    inputs, _, ranks_out = results
    got = sum(ranks_out[0][f"tot_a_{i}"] for i in range(STEPS))
    want = inputs["ga"].sum(axis=(0, 1))
    assert np.abs(got - want).max() / np.abs(want).max() < 0.05

"""The port's input specifications (``repro_torch.launch.specs``:
``prefill_specs`` and ``decode_specs``) against the reference's
(``repro.launch.specs``), on the CPU.

For every architecture and each shape its cells run (``cells``), at full
size and at ``smoke()``: the same keys, shapes and dtypes as the
reference's trees of ``ShapeDtypeStruct`` (the audio codebooks, the
VLM's ``VLM_PATCH_TOKENS`` patch embeddings with M-RoPE positions, the
decode step's one token a row), and for ``decode_specs``' cache the
reference's ``jax.eval_shape`` of ``init_cache(B, S)``, leaf for leaf.
By default the port's trees are ``meta`` tensors; on ``"cpu"`` they hold
the reference's ``concrete=True`` values (the smoke sizes; the VLM's
smoke sequence is ``VLM_PATCH_TOKENS`` longer, so that its text is not
empty).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.models import build as jbuild
from repro_torch import configs as tconfigs
from repro_torch.launch import specs as tspecs
from repro_torch.models import build

CELLS = [(a, s) for a in jconfigs.ARCH_IDS
         for s, ok in jconfigs.cells(a).items() if ok]
SIZES = ("full", "smoke")
IDS = [f"{a}-{s}" for a, s in CELLS]


def _configs(arch: str, shape: str, size: str):
    jcfg, cfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jshape, tshape = jconfigs.SHAPES[shape], tconfigs.SHAPES[shape]
    if size == "smoke":
        jcfg, cfg = jcfg.smoke(), cfg.smoke()
        jshape, tshape = jshape.smoke(), tshape.smoke()
        if cfg.modality == "vlm":     # room for the patch embeddings
            S = jspecs.VLM_PATCH_TOKENS + jshape.seq_len
            jshape = dataclasses.replace(jshape, seq_len=S)
            tshape = dataclasses.replace(tshape, seq_len=S)
    return jcfg, cfg, jshape, tshape


def _flat(tree, path=()) -> dict:
    """path -> leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key],
                                                      path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in _flat(x, path + (i,)).items()}
    return {path: tree}


def _layout(tree) -> dict:
    """path -> (shape, dtype name) of jax ``ShapeDtypeStruct`` s / arrays
    or torch tensors."""
    out = {}
    for path, x in _flat(tree).items():
        dtype = str(x.dtype).replace("torch.", "")
        out[path] = (tuple(x.shape), dtype)
    return out


def _assert_same_layout(got, want) -> None:
    got, want = _layout(got), _layout(want)
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_prefill_specs_equal_the_reference(arch, shape, size):
    jcfg, cfg, jshape, tshape = _configs(arch, shape, size)
    got = tspecs.prefill_specs(cfg, tshape)
    assert all(t.device.type == "meta" for t in _flat(got).values())
    _assert_same_layout(got, jspecs.prefill_specs(jcfg, jshape))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_decode_specs_equal_the_reference(arch, shape, size):
    """The tokens and positions, and the cache at ``seq_len`` capacity
    against ``jax.eval_shape(lambda: model.init_cache(B, S))``."""
    jcfg, cfg, jshape, tshape = _configs(arch, shape, size)
    jmodel = jbuild(jcfg)
    got = tspecs.decode_specs(cfg, tshape, build(cfg, device="meta"))
    want = jspecs.decode_specs(jcfg, jshape, jmodel)
    assert all(t.device.type == "meta" for t in _flat(got).values())
    _assert_same_layout(got, want)
    B, S = jshape.global_batch, jshape.seq_len
    _assert_same_layout(got["cache"], jax.eval_shape(
        lambda: jmodel.init_cache(B, S)))


def _values(tree) -> dict:
    return {k: np.asarray(v.float().numpy() if isinstance(v, torch.Tensor)
                          else np.asarray(v, np.float32) if v.dtype.name
                          == "bfloat16" else v)
            for k, v in _flat(tree).items()}


def _assert_same_values(got, want) -> None:
    _assert_same_layout(got, want)
    got, want = _values(got), _values(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_concrete_values_on_the_cpu(arch, shape):
    """At the smoke sizes on ``"cpu"``: the reference's ``concrete=True``
    values (zeros; the cache's ``init_cache`` fills, such as zamba2's
    empty ring positions), a model on another device rebuilt there."""
    jcfg, cfg, jshape, tshape = _configs(arch, shape, "smoke")
    got = tspecs.prefill_specs(cfg, tshape, device="cpu")
    assert all(t.device.type == "cpu" for t in _flat(got).values())
    _assert_same_values(got, jspecs.prefill_specs(jcfg, jshape,
                                                  concrete=True))
    got = tspecs.decode_specs(cfg, tshape, build(cfg, device="meta"),
                              device="cpu")
    assert all(t.device.type == "cpu" for t in _flat(got).values())
    _assert_same_values(got, jspecs.decode_specs(jcfg, jshape, jbuild(jcfg),
                                                 concrete=True))


def test_decode_specs_of_a_cpu_model_stay_on_meta():
    """The default device is ``meta`` whatever the model's: nothing is
    allocated for a full-size cache (llama3-8b's decode_32k: 4.3e9
    elements a leaf)."""
    cfg = tconfigs.get_config("llama3-8b")
    model = build(cfg.smoke(), device="cpu")
    spec = tspecs.decode_specs(cfg.smoke(), tconfigs.SHAPES["decode_32k"],
                               model)
    assert {t.device.type for t in _flat(spec).values()} == {"meta"}
    full = tspecs.decode_specs(cfg, tconfigs.SHAPES["decode_32k"],
                               build(cfg, device="meta"))
    assert full["cache"]["layers"]["k"].numel() == (
        32 * 128 * 32768 * cfg.n_kv_heads * cfg.resolved_head_dim)

"""The port's LM serving engine (``repro_torch.serve.Engine``) against the
reference's (``repro.serve.Engine``) on the same weights, on the CPU:
twins of ``tests/test_serve.py``'s LM tests.

Weights: each smoke model's reference ``init`` (``jax.random.key(0)``),
carried into the port by ``convert.lm_params_from_arrays``; prompts drawn
by ``jax.random.randint`` as in the reference's tests.

- Prefill then decode against ``forward``, for all ten smoke configs, with
  the reference test's bounds (relative to the logits' largest: prefill
  0.05, 0.35 with MoE; decode that + 0.08, or for deep stacks top-1 equal
  and 0.5).
- Greedy ``generate`` in f32: tokens equal to the reference engine's,
  token for token; deterministic; shape (B, n).  Sampling at a
  temperature draws from a ``torch.Generator`` (the reference's JAX key
  stream is not reproduced), so there only the shape, the range and
  determinism under one seed are held.
- ``serve_continuous`` equal to the port's own ``generate``, request for
  request, at capacity 2 (lanes reused, mixed ``max_new``, early
  release).
- ``_scatter_cache`` bit for bit against the reference's on every
  model's ``cache_axes``, and on the first admission, where the base is
  the new cache itself.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.models import build as jbuild
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro.serve.engine import _scatter_cache as j_scatter
from repro_torch import serve_lm
from repro_torch.configs import get_config as tget
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import build
from repro_torch.models.base import leaves
from repro_torch.serve import (Engine, Request, ServeConfig, Tracer,
                               validate_events)
from repro_torch.serve.engine import _scatter_cache

from _torch_lm_fields import reference_fields

ENGINE_ARCHS = ["qwen3-8b", "rwkv6-7b", "zamba2-7b"]


def _pair(name, dtype=None):
    """(reference model, its params, the port's model on the same
    weights) at smoke size, optionally in another compute dtype."""
    cfg_j, cfg_t = jget(name).smoke(), tget(name).smoke()
    if dtype is not None:
        cfg_j = dataclasses.replace(cfg_j, dtype=dtype)
        cfg_t = dataclasses.replace(cfg_t, dtype=dtype)
    jm = jbuild(cfg_j)
    params = jm.init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    return jm, params, lm_params_from_arrays(cfg_t, tree, device="cpu")


def _prompts(key, shape, vocab):
    return np.asarray(jax.random.randint(jax.random.key(key), shape, 0,
                                         vocab)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_matches_forward(arch):
    """The twin of ``test_serve.py::test_prefill_decode_matches_forward``
    on the port, with its bounds."""
    _, _, model = _pair(arch)
    cfg = model.cfg
    B, S = 2, 33
    shape = (B, S, cfg.n_codebooks) if cfg.modality == "audio" else (B, S)
    toks = torch.from_numpy(_prompts(2, shape, cfg.vocab))
    pos = torch.arange(S).expand(B, S)
    if cfg.rope_style == "mrope":
        pos = torch.arange(S).expand(3, B, S)
    logits_full, _ = model.forward(toks, pos)

    lp, cache = model.prefill(toks[:, :S - 1], pos[..., :S - 1], 96)
    scale = float(logits_full[:, S - 2].abs().max()) + 1e-6
    rel_prefill = float((lp[:, 0] - logits_full[:, S - 2]).abs().max()) \
        / scale
    tol = 0.35 if cfg.moe is not None else 0.05
    assert rel_prefill < tol, (arch, rel_prefill)

    dpos = (torch.full((3, B, 1), S - 1) if cfg.rope_style == "mrope"
            else torch.full((B, 1), S - 1))
    ld, _ = model.decode_step(cache, toks[:, S - 1:S], dpos)
    scale = float(logits_full[:, S - 1].abs().max()) + 1e-6
    rel = float((ld[:, 0] - logits_full[:, S - 1]).abs().max()) / scale
    if cfg.n_layers * (3 if cfg.hybrid_attn_every else 1) > 8:
        np.testing.assert_array_equal(ld[:, 0].argmax(-1).numpy(),
                                      logits_full[:, S - 1].argmax(-1)
                                      .numpy())
        assert rel < 0.5, (arch, rel)
    else:
        assert rel < tol + 0.08, (arch, rel)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_generate_greedy_equals_the_reference(arch):
    """f32 greedy tokens equal to the reference engine's; the port's are
    deterministic, (B, n) int32, and come with the reference's stats."""
    jm, params, model = _pair(arch, "float32")
    prompts = _prompts(1, (2, 16), model.cfg.vocab)
    want, _ = JEngine(jm, params, JServeConfig(max_len=64)).generate(
        jnp.asarray(prompts), 6)
    eng = Engine(model, ServeConfig(max_len=64, temperature=0.0))
    g1, s1 = eng.generate(prompts, 6)
    g2, _ = eng.generate(torch.from_numpy(prompts), 6)
    assert g1.shape == (2, 6) and g1.dtype == torch.int32
    np.testing.assert_array_equal(g1.numpy(), np.asarray(want))
    np.testing.assert_array_equal(g1.numpy(), g2.numpy())
    assert s1["decode_tok_per_s"] > 0 and s1["tokens"] == 12
    assert set(s1) == {"prefill_s", "decode_s", "tokens",
                       "decode_tok_per_s"}


def test_long_decode_recurrent():
    """rwkv6 decodes with O(1) state: generate 3x past ``max_len``,
    greedy equal to the reference's in f32, and sampled at a temperature
    (the reference test's setting) in range and repeatable under a seed."""
    jm, params, model = _pair("rwkv6-7b", "float32")
    prompts = _prompts(1, (2, 8), model.cfg.vocab)
    want, _ = JEngine(jm, params, JServeConfig(max_len=8)).generate(
        jnp.asarray(prompts), 24)
    got, _ = Engine(model, ServeConfig(max_len=8)).generate(prompts, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    eng = Engine(model, ServeConfig(max_len=8, temperature=0.7))
    a, _ = eng.generate(prompts, 24, seed=3)
    b, _ = eng.generate(prompts, 24, seed=3)
    assert a.shape == (2, 24)
    assert ((a >= 0) & (a < model.cfg.vocab)).all()
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_continuous_serving_matches_generate(arch):
    """The twin of ``test_continuous_lm_serving_matches_generate``: 5
    requests through 2 lanes give, request for request, ``generate``'s
    greedy tokens; a tracer sees every request's span."""
    _, _, model = _pair(arch)
    eng = Engine(model, ServeConfig(max_len=64, temperature=0.0),
                 trace=Tracer())
    prompts = _prompts(1, (5, 8), model.cfg.vocab)
    ref, _ = eng.generate(prompts, 4)
    reqs = [Request(i, prompts[i], max_new=4) for i in range(5)]
    gen, stats = eng.serve_continuous(reqs, capacity=2, seed=0)
    assert set(gen) == set(range(5))
    for i in range(5):
        np.testing.assert_array_equal(np.asarray(gen[i]).ravel(),
                                      ref[i].numpy().ravel())
    assert stats["capacity"] == 2
    assert stats["latency"]["n"] == 5
    assert stats["decode_steps"] >= 9
    events = eng.trace.to_json()
    validate_events(events)
    names = [e["name"] for e in events if e["ph"] == "B"]
    assert names.count("request") == 5
    assert {"prefill", "decode", "decode_step"} <= set(names)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_continuous_mixed_lengths_release_early(arch):
    """The twin of ``test_continuous_lm_mixed_lengths_release_early``: a
    short request beside a long one finishes first and its lane serves a
    later request."""
    _, _, model = _pair(arch)
    eng = Engine(model, ServeConfig(max_len=64, temperature=0.0))
    prompts = _prompts(4, (3, 8), model.cfg.vocab)
    ref, _ = eng.generate(prompts, 6)
    max_new = [2, 6, 3]
    reqs = [Request(i, prompts[i], max_new=max_new[i]) for i in range(3)]
    gen, _ = eng.serve_continuous(reqs, capacity=2, seed=0)
    for i in range(3):
        np.testing.assert_array_equal(np.asarray(gen[i]).ravel(),
                                      ref[i].numpy().ravel()[:max_new[i]])


def test_eos_releases_the_lane():
    """A request whose first token is the EOS id stops there."""
    _, _, model = _pair("qwen3-8b")
    prompts = _prompts(1, (2, 8), model.cfg.vocab)
    first = Engine(model, ServeConfig(max_len=64)).generate(prompts, 1)[0]
    eng = Engine(model, ServeConfig(max_len=64, eos_id=int(first[0, 0])))
    gen, _ = eng.serve_continuous(
        [Request(i, prompts[i], max_new=5) for i in range(2)], capacity=2)
    assert len(gen[0]) == 1
    with pytest.raises(ValueError, match="equal-length"):
        eng.serve_continuous([Request(0, prompts[0], 2),
                              Request(1, prompts[1][:5], 2)])


def _np_tree(cache):
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node.float().numpy() if node.is_floating_point() \
            else node.numpy()
    return walk(cache)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_scatter_cache_on_every_model(arch):
    """Lanes of a new cache written into a live one, and the first
    admission (the base is the new cache itself, lanes overlapping), bit
    for bit against the reference's ``_scatter_cache``; the port's
    ``cache_axes`` equal the reference's."""
    cfg = tget(arch).smoke()
    model = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    axes = model.cache_axes()
    assert axes == jbuild(jget(arch).smoke()).cache_axes()
    B, S = 3, 6
    shape = (B, S, cfg.n_codebooks) if cfg.modality == "audio" else (B, S)
    rng = np.random.default_rng(0)
    pos = torch.arange(S).expand(B, S)
    if cfg.rope_style == "mrope":
        pos = torch.arange(S).expand(3, B, S)
    live = model.prefill(torch.from_numpy(rng.integers(0, cfg.vocab, shape)),
                         pos, 16)[1]
    live = model.decode_step(live, torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, 1) + shape[2:])),
        pos[..., -1:] + 1)[1]
    new = model.prefill(torch.from_numpy(rng.integers(0, cfg.vocab, shape)),
                        pos, 16)[1]
    jax_axes = jax.tree.map(tuple, axes, is_leaf=lambda x: isinstance(
        x, tuple))
    for base, src, dst in ((live, [2, 0], [0, 2]), (new, [2, 0], [0, 1])):
        want = j_scatter(jax.tree.map(jnp.asarray, _np_tree(base)), jax_axes,
                         jax.tree.map(jnp.asarray, _np_tree(new)),
                         np.asarray(src), np.asarray(dst))
        out = _scatter_cache(base, axes, new, src, dst)
        assert out is base
        got, ref = dict(leaves(_np_tree(out))), dict(leaves(
            jax.tree.map(np.asarray, want)))
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k].astype(
                got[k].dtype), err_msg=f"{arch} {k}")
    with pytest.raises(ValueError, match="cache_axes"):
        _scatter_cache(live, {"layers": {}}, new, [0], [0])


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_serve_lm_on_the_cpu(arch, capsys):
    """``python -m repro_torch.serve_lm --device cpu`` on a small run."""
    served = serve_lm.main(["--arch", arch, "--device", "cpu",
                            "--tokens", "3", "--requests", "2"])
    assert served == 2
    out = capsys.readouterr().out
    assert "served 2 requests" in out and "on cpu" in out


def test_serve_lm_keeps_the_reference_variant():
    import sys
    import pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "examples"))
    from train_lm import hundred_m_variant
    for arch in ARCH_IDS:
        assert reference_fields(serve_lm.hundred_m_variant(tget(arch))) \
            == dataclasses.asdict(hundred_m_variant(jget(arch)))

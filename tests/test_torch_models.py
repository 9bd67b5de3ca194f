"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``)
held against the JAX reference (``repro.models``, ``repro.configs``) on
the same parameters and the same numpy inputs, on the CPU.

The reference initialises each smoke model with its own ``init``
(``jax.random.key(0)``); the tree crosses into the port through
``convert.lm_params_from_arrays``.  One module fixture a architecture
runs the reference once (jitted forward + loss for the f32 and the bf16
variant, prefill and four decode steps in bf16) and keeps its outputs.

Tolerances. Both packages round q, k, v, the attention probabilities and
the caches to bf16, as the reference does. A tiny f32 difference (the
two packages' GEMMs sum in other orders; XLA's rsqrt and one-hot
contractions differ by an ulp) can move one of those roundings by one
bf16 ulp (2^-8 relative), and the reference's init makes attention
nearly one-hot (its fan-in is ``shape[-2]``, so q and k have std 10-20
at d = 64), so such a step moves the softmax weights of the keys it
touches, and the layers after it carry it on. The logits therefore agree
to rounding at most positions and less at a few, and how far at those
few depends on the draws: each comparison bounds the median, the 99th
percentile and the maximum of |got - want|, each relative to max |want|
(``_close``). The median carries the check (a wrong layer moves it to
the logits' own scale); the tail bounds only allow the flips. Measured
over the eight architectures with the reference's constant norm
parameters and with two draws of them (``_perturb_norms`` seeds 2 and 0,
the one kept): f32 logits median up to 7.4e-6, p99 1.7e-3, max 1.0e-2;
bf16 logits, prefill and decode median up to 5.6e-3, p99 2.9e-2, max
1.7e-1; bf16 caches median 0, p99 3.3e-3, max 4.0e-2. The bounds: f32
(3e-5, 1e-2, 1e-1); bf16 logits a median of 2^-6 (two bf16 ulps at the
top of the range, as the logits are bf16 before the f32 cast), then 0.1
and 0.5; caches (1e-3, 2e-2, 0.1). Argmax agrees at every f32 position
and at 95.8% or more of the bf16 ones; the bound is 90% (not 99%), and
every differing position must be a tie that its own row's error explains
(``_argmax_agrees``). Cache lengths, MoE dispatch integers, parameter
counts, declarations and configs are exact; the norms, MLPs, attention
and rope pieces on moderate random inputs are held to a few f32 ulps
(bf16 norms to one bf16 ulp), where the init's one-hot attention cannot
amplify.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import base as jbase
from repro.models import build as jbuild
from repro.models import ffn as jffn
from repro.models import rope as jrope
from repro.models.base import NULL_CTX
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_arrays, lm_params_from_arrays
from repro_torch.models import attention as tattn
from repro_torch.models import base as tbase
from repro_torch.models import build, ffn as tffn
from repro_torch.models import rope as trope
from repro_torch.models.base import axes_tree, leaves

from _torch_lm_fields import reference_fields

LM_ARCHS = [a for a in jconfigs.ARCH_IDS
            if jconfigs.get_config(a).ssm is None]
B, S, S_IMG, MAX_LEN, DECODE_STEPS = 2, 48, 8, 64, 4

# (median, p99, max) of |got - want| / max |want|; see the module doc.
F32_BOUNDS = (3e-5, 1e-2, 1e-1)
BF16_BOUNDS = (2 ** -6, 1e-1, 5e-1)
CACHE_BOUNDS = (1e-3, 2e-2, 1e-1)
LOSS_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
ARGMAX_SHARE = 0.9


def _close(name, got, want, bounds):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want) / max(np.abs(want).max(), 1e-30)
    stats = (np.median(err), np.quantile(err, 0.99), err.max())
    for label, s, b in zip(("median", "p99", "max"), stats, bounds):
        assert s <= b, f"{name}: {label} rel err {s:.3e} > {b:.1e}"
    return stats


def _argmax_agrees(name, got, want, min_share=ARGMAX_SHARE):
    """Argmax over the last axis equal at ``min_share`` of the positions
    or more, and at every other one a tie that the position's own error
    explains: the reference's top exceeds its logit at the port's argmax
    by no more than twice the row's max |got - want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    g, w = got.argmax(-1), want.argmax(-1)
    top = np.take_along_axis(want, w[..., None], -1)[..., 0]
    at_g = np.take_along_axis(want, g[..., None], -1)[..., 0]
    tie = top - at_g <= 2 * np.abs(got - want).max(-1)
    assert np.all((g == w) | tie), \
        f"{name}: argmax differs at {int(((g != w) & ~tie).sum())} positions"
    assert (g == w).mean() >= min_share, \
        f"{name}: argmax agrees at {(g == w).mean():.3f} of the positions"


def _inputs(cfg, seed=0):
    """tokens, positions and (vlm) patch embeddings from numpy."""
    rng = np.random.default_rng(seed)
    shape = ((B, S, cfg.n_codebooks) if cfg.modality == "audio"
             else (B, S))
    tokens = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    extra = None
    if cfg.rope_style == "mrope":
        # a 2 x 4 patch grid at t = 0, then text on all three streams
        grid = np.stack([np.zeros(S_IMG), np.arange(S_IMG) // 4,
                         np.arange(S_IMG) % 4])
        text = np.broadcast_to(np.arange(S) + 4, (3, S))
        pos = np.concatenate([grid, text], 1).astype(np.int32)
        positions = np.ascontiguousarray(
            np.broadcast_to(pos[:, None], (3, B, S_IMG + S)))
        extra = rng.standard_normal((B, S_IMG, cfg.d_model)).astype(
            np.float32)
    else:
        positions = np.ascontiguousarray(
            np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)))
    return tokens, positions, extra


def _batch(tokens, positions, extra, to):
    b = {"tokens": to(tokens), "positions": to(positions)}
    if extra is not None:
        b["extra_embeds"] = to(extra)
    return b


def _decode_inputs(cfg, positions, seed=1):
    """DECODE_STEPS (tokens (B, 1[, C]), positions) after the prompt."""
    rng = np.random.default_rng(seed)
    last = positions[..., -1:]
    steps = []
    for t in range(DECODE_STEPS):
        shape = ((B, 1, cfg.n_codebooks) if cfg.modality == "audio"
                 else (B, 1))
        steps.append((rng.integers(0, cfg.vocab, shape).astype(np.int32),
                      (last + 1 + t).astype(np.int32)))
    return steps


def _np(tree):
    return jax.tree.map(np.asarray, tree)


NORM_LEAVES = ("gamma", "beta", "kv_norm", "q_gamma", "k_gamma")


def _perturb_norms(tree, seed=0):
    """The reference's init sets every norm scale and shift to a constant;
    draw them instead (std 0.1 about it), so the end-to-end tests see a
    norm that reads its parameters wrongly."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (v + 0.1 * rng.standard_normal(v.shape).astype(
                        v.dtype) if k in NORM_LEAVES else walk(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node
    return walk(tree)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=LM_ARCHS)
def arch(request):
    """Everything the reference computes for one architecture."""
    name = request.param
    base = jconfigs.get_config(name).smoke()
    jmodel = jbuild(base)
    tree = _perturb_norms(_np(jmodel.init(jax.random.key(0))))
    params = jax.tree.map(jnp.asarray, tree)
    tokens, positions, extra = _inputs(base)
    out = dict(name=name, tree=tree, inputs=(tokens, positions, extra))
    batch = _batch(tokens, positions, extra, jnp.asarray)
    for dt in ("float32", "bfloat16"):
        m = jbuild(dataclasses.replace(base, dtype=dt))

        def fwd_loss(p, b, m=m):
            logits, aux = m.forward(p, b["tokens"], b["positions"],
                                    b.get("extra_embeds"))
            return logits, aux, m.loss(p, b)
        out[dt] = _np(jax.jit(fwd_loss)(params, batch))
    # prefill + decode in the shipped dtype (bf16)
    logits, cache = jax.jit(jmodel.prefill, static_argnums=3)(
        params, batch["tokens"], batch["positions"], MAX_LEN,
        batch.get("extra_embeds"))
    out["prefill"] = (np.asarray(logits), _np(cache))
    step = jax.jit(jmodel.decode_step)
    steps = []
    for tok, pos in _decode_inputs(base, positions):
        logits, cache = step(params, cache, jnp.asarray(tok),
                             jnp.asarray(pos))
        steps.append((np.asarray(logits), _np(cache)))
    out["decode"] = steps
    return out


def _port(arch, dtype):
    cfg = dataclasses.replace(tconfigs.get_config(arch["name"]).smoke(),
                              dtype=dtype)
    return lm_params_from_arrays(cfg, arch["tree"], device="cpu")


# -- configs, counts, declarations ------------------------------------------

def test_registry_equals_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    assert tconfigs.all_cells() == jconfigs.all_cells()
    for a in jconfigs.ARCH_IDS:
        assert tconfigs.cells(a) == jconfigs.cells(a)
    assert ({k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in jconfigs.SHAPES.items()})
    for k, v in tconfigs.SHAPES.items():
        assert (dataclasses.asdict(v.smoke())
                == dataclasses.asdict(jconfigs.SHAPES[k].smoke()))


@pytest.mark.parametrize("name", jconfigs.ARCH_IDS)
def test_config_equals_reference(name):
    """Equal on the reference's fields; the port's own fields (the
    published models' settings) at the defaults that reproduce the
    reference's mathematics (``tests/_torch_lm_fields.py``)."""
    got, want = tconfigs.get_config(name), jconfigs.get_config(name)
    assert reference_fields(got) == dataclasses.asdict(want)
    assert reference_fields(got.smoke()) == dataclasses.asdict(
        want.smoke())
    assert got.resolved_head_dim == want.resolved_head_dim


@pytest.mark.parametrize("name", jconfigs.ARCH_IDS)
def test_full_size_counts_without_allocating(name):
    """``n_params`` and the abstract tree at full size, on the meta
    device: exact against the reference."""
    model = build(tconfigs.get_config(name), device="meta")
    want = jbuild(jconfigs.get_config(name))
    assert model.n_params() == want.n_params()
    assert all(t.is_meta for t in model.parameters())
    assert sum(t.numel() for t in model.parameters()) == want.n_params()
    got = dict(leaves(model.abstract()))
    ref = jax.tree_util.tree_flatten_with_path(want.abstract())[0]
    assert len(got) == len(ref)
    for path, s in ref:
        key = tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in path)
        assert got[key].is_meta and tuple(got[key].shape) == s.shape, key


@pytest.mark.parametrize("name", jconfigs.ARCH_IDS)
def test_declarations_map_onto_the_reference(name):
    """The port's declaration tree equals the reference's leaf for leaf
    (shape, axes, init, scale), and its state dict holds each leaf once,
    a stacked leaf once a layer."""
    cfg_t = tconfigs.get_config(name).smoke()
    cfg_j = jconfigs.get_config(name).smoke()
    model = build(cfg_t, device="meta")
    got = dict(leaves(model.decls()))
    ref = jax.tree_util.tree_flatten_with_path(
        jbuild(cfg_j).decls(), is_leaf=lambda x: hasattr(x, "axes"))[0]
    assert len(got) == len(ref)
    names = set(model.state_dict())
    expect = set()
    for path, p in ref:
        key = tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in path)
        q = got[key]
        assert (q.shape, q.axes, q.init, q.scale) == \
            (p.shape, p.axes, p.init, p.scale), key
        dotted = ".".join(map(str, key[1:]))
        if key[0] == "layers":
            expect |= {f"params.layers.{i}.{dotted}"
                       for i in range(p.shape[0])}
        else:
            expect.add(".".join(["params", *map(str, key)]))
    assert names == expect
    assert axes_tree(model.decls()) == jbuild(cfg_j).axes()


# -- forward, loss, prefill, decode ----------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss(arch, dtype):
    model = _port(arch, dtype)
    tokens, positions, extra = arch["inputs"]
    want_logits, want_aux, (want_loss, want_metrics) = arch[dtype]
    logits, aux = model.forward(_t(tokens), _t(positions), _t(extra))
    bounds = F32_BOUNDS if dtype == "float32" else BF16_BOUNDS
    _close("logits", logits, want_logits, bounds)
    _argmax_agrees("logits", logits, want_logits,
                   1.0 if dtype == "float32" else ARGMAX_SHARE)
    loss, metrics = model.loss(_batch(tokens, positions, extra, _t))
    np.testing.assert_allclose(float(loss), want_loss,
                               rtol=LOSS_RTOL[dtype])
    for k in ("ce", "zloss"):
        np.testing.assert_allclose(float(metrics[k]), want_metrics[k],
                                   rtol=LOSS_RTOL[dtype])
    # the aux loss counts routing decisions: exact but for a flipped one
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-2, atol=1e-6)


def test_prefill_and_decode(arch):
    """Prefill's last logits and its bf16 cache, then four decode steps'
    logits and caches, in the shipped bf16 dtype; lengths exact."""
    model = _port(arch, "bfloat16")
    tokens, positions, extra = arch["inputs"]
    logits, cache = model.prefill(_t(tokens), _t(positions), MAX_LEN,
                                  _t(extra))
    want_logits, want_cache = arch["prefill"]
    _close("prefill logits", logits, want_logits, BF16_BOUNDS)
    _check_cache("prefill", cache, want_cache)
    decode = _decode_inputs(model.cfg, positions)
    for t, ((want_logits, want_cache), (tok, pos)) in enumerate(
            zip(arch["decode"], decode)):
        logits, cache = model.decode_step(cache, _t(tok), _t(pos))
        _close(f"decode {t} logits", logits, want_logits, BF16_BOUNDS)
        _argmax_agrees(f"decode {t}", logits, want_logits, 0.5)
        _check_cache(f"decode {t}", cache, want_cache)


def _cache_close(name, got, want, bounds):
    assert set(got) == set(want), name
    for k in want:
        if k == "len":
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        else:
            assert got[k].dtype == torch.bfloat16
            _close(f"{name}.{k}", got[k].float(), want[k], bounds)


def _check_cache(name, cache, want):
    _cache_close(f"{name} layers", cache["layers"], want["layers"],
                 CACHE_BOUNDS)
    assert len(cache.get("front", [])) == len(want.get("front", []))
    for i, (c, w) in enumerate(zip(cache.get("front", []),
                                   want.get("front", []))):
        _cache_close(f"{name} front {i}", c, w, CACHE_BOUNDS)


def test_reference_runs_on_the_ports_draws():
    """``init`` draws from a generator; ``lm_arrays`` takes the draws back
    to the reference's tree, and the reference's forward on them equals
    the port's (f32); the round trip through ``lm_params_from_arrays`` is
    exact."""
    cfg_t = dataclasses.replace(tconfigs.get_config("qwen3-8b").smoke(),
                                dtype="float32")
    model = build(cfg_t, device="cpu").init(
        torch.Generator().manual_seed(0))
    again = build(cfg_t, device="cpu").init(
        torch.Generator().manual_seed(0))
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), k
    tree = lm_arrays(model)
    back = lm_params_from_arrays(cfg_t, tree, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, back.state_dict()[k]), k
    wq = tree["layers"]["attn"]["wq"]
    assert abs(wq.std() - 1 / np.sqrt(cfg_t.n_heads)) < 0.02
    tokens, positions, _ = _inputs(cfg_t)
    jm = jbuild(dataclasses.replace(jconfigs.get_config("qwen3-8b").smoke(),
                                    dtype="float32"))
    want = jax.jit(jm.forward)(tree, jnp.asarray(tokens),
                               jnp.asarray(positions))[0]
    got = model.forward(_t(tokens), _t(positions))[0]
    _close("logits on the port's draws", got, want, F32_BOUNDS)


# -- attention and rope pieces ---------------------------------------------

RTOL_PIECES = 2e-6     # a few f32 ulps on O(1)-O(10) values
ULP2 = 2.0 ** -22      # two f32 ulps


@pytest.mark.parametrize("Sq,q_offset", [(37, 0), (37, 11), (64, 0)])
def test_chunked_attention(Sq, q_offset):
    """Ragged S (not a multiple of the chunk), with and without a query
    offset, GQA-expanded heads and a v width of its own; q_offset > 0
    leaves the first rows of the first chunks with no visible key."""
    rng = np.random.default_rng(Sq + q_offset)
    Sk = Sq + q_offset
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32) * 3
    k = rng.standard_normal((2, Sk, 4, 16)).astype(np.float32) * 3
    v = rng.standard_normal((2, Sk, 4, 8)).astype(np.float32)
    kw = dict(scale=0.25, q_chunk=16, k_chunk=8, q_offset=q_offset)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = tattn.chunked_attention(*map(_t, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL_PIECES, atol=RTOL_PIECES)


def test_chunked_attention_masks_rows_with_no_key():
    """Keys that all sit past the queries: every row is masked, and the
    guard gives zeros, not NaN, in both packages."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 8, 2, 4)).astype(np.float32)
    k = rng.standard_normal((1, 8, 2, 4)).astype(np.float32)
    kw = dict(scale=0.5, q_chunk=4, k_chunk=4, q_offset=-8)
    want = np.asarray(jattn.chunked_attention(
        *map(jnp.asarray, (q, k, k)), **kw))
    got = tattn.chunked_attention(*map(_t, (q, k, k)), **kw).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_decode_attention():
    """Per-row cache lengths; entries at and past the length (filled with
    garbage here) are masked."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 1, 8, 16)).astype(np.float32) * 3
    kc = rng.standard_normal((3, 20, 2, 16)).astype(np.float32) * 3
    vc = rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
    lens = np.array([1, 7, 20], np.int32)
    want = jattn.decode_attention(*map(jnp.asarray, (q, kc, vc, lens)),
                                  scale=0.25)
    got = tattn.decode_attention(*map(_t, (q, kc, vc, lens)), scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL_PIECES, atol=RTOL_PIECES)


def test_rope():
    rng = np.random.default_rng(4)
    pos = rng.integers(0, 4096, (2, 24)).astype(np.int32)
    for hd, theta in ((16, 1e4), (128, 5e5), (64, 1e6)):
        np.testing.assert_array_equal(
            trope.rope_freqs(hd, theta).numpy(),
            np.asarray(jrope.rope_freqs(hd, theta)))
        want = np.asarray(jrope.rope_angles(jnp.asarray(pos), hd, theta))
        got = trope.rope_angles(_t(pos), hd, theta).numpy()
        np.testing.assert_array_equal(got, want)
    # M-RoPE: the port's one-hot pick is exact (pos * inv); XLA's
    # contraction is one ulp off in about 1% of the lanes at hd = 128.
    pos3 = rng.integers(0, 64, (3, 2, 24)).astype(np.int32)
    for sections, hd in (((4, 2, 2), 16), ((16, 24, 24), 128)):
        want = np.asarray(jrope.mrope_angles(jnp.asarray(pos3), hd, 1e6,
                                             sections))
        got = trope.mrope_angles(_t(pos3), hd, 1e6, sections).numpy()
        np.testing.assert_allclose(got, want, rtol=ULP2, atol=0)
    x = rng.standard_normal((2, 24, 3, 16)).astype(np.float32) * 4
    ang = np.asarray(jrope.rope_angles(jnp.asarray(pos), 16, 1e4))
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(ang)))
    got = trope.apply_rope(_t(x), _t(ang)).numpy()
    # cos/sin of angles up to 4096 rad: one ulp of the angle is 2.4e-4
    np.testing.assert_allclose(got, want, rtol=RTOL_PIECES, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(dtype):
    """rms_norm scales by (1 + gamma) with an f32 variance; layer_norm
    with an f32 mean and population variance.  f32 to a few ulps; bf16 to
    one bf16 ulp (XLA may skip the rounding between fused steps)."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((3, 5, 32)) * 4).astype(np.float32)
    g, b = (rng.standard_normal((2, 32)) * 0.5).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tol = RTOL_PIECES if dtype == "float32" else 2.0 ** -7
    jx, tx = jnp.asarray(x).astype(jdt), _t(x).to(tdt)
    for want, got in (
            (jbase.rms_norm(jx, jnp.asarray(g)), tbase.rms_norm(tx, _t(g))),
            (jbase.layer_norm(jx, jnp.asarray(g), jnp.asarray(b)),
             tbase.layer_norm(tx, _t(g), _t(b)))):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu", "relu2"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_forward(act, gated):
    """Each activation (gelu is the tanh form), gated and plain, in f32."""
    rng = np.random.default_rng(7)
    decls = jffn.decls_mlp(16, 24, gated)
    p = {k: (rng.standard_normal(d.shape) / 4).astype(np.float32)
         for k, d in decls.items()}
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 2
    want = jffn.mlp_forward({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), act, NULL_CTX)
    got = tffn.mlp_forward({k: _t(v) for k, v in p.items()}, _t(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fn", ["silu", "gelu", "sigmoid"])
def test_activations_match_jax_bitwise_in_bf16(fn):
    """XLA evaluates ``jax.nn.silu`` / ``gelu(approximate=True)`` /
    ``sigmoid`` in bf16 step by step, each step rounded, its constants
    rounded to bf16; the port's activations do the same and agree bit for
    bit (``F.silu`` and ``F.gelu`` round once and differ in a third of
    the lanes); in f32 within a few ulps, or 1e-6 absolute where gelu's
    value is tiny (XLA's f32 tanh is its own approximation)."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    jfn = {"silu": jax.nn.silu, "sigmoid": jax.nn.sigmoid,
           "gelu": lambda v: jax.nn.gelu(v, approximate=True)}[fn]
    tfn = {"silu": tbase.silu, "sigmoid": tbase.sigmoid,
           "gelu": tbase.gelu_tanh}[fn]
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        want = np.asarray(jax.jit(jfn)(jnp.asarray(x).astype(jdt))
                          .astype(jnp.float32))
        got = tfn(_t(x).to(tdt)).float().numpy()
        if tdt == torch.bfloat16:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL_PIECES,
                                       atol=1e-6)


# -- mixture of experts ------------------------------------------------------

def _moe_case(seed=5):
    """Both packages' deepseek smoke config at d = 16 with 8 experts, top
    2 and capacity factor 0.5 (tokens dropped), f32 parameters drawn from
    numpy and a router scaled x3 so the top-k probabilities spread."""
    cfgs = []
    for mod in (jconfigs, tconfigs):
        cfg = mod.get_config("deepseek-v2-lite-16b").smoke()
        cfgs.append(dataclasses.replace(
            cfg, d_model=16, dtype="float32", moe=dataclasses.replace(
                cfg.moe, n_experts=8, top_k=2, d_ff_expert=12,
                n_shared=1, capacity_factor=0.5)))
    rng = np.random.default_rng(seed)
    params = {}
    for path, decl in jax.tree_util.tree_flatten_with_path(
            jffn.decls_moe(cfgs[0]), is_leaf=lambda x: hasattr(x, "axes"))[0]:
        node = params
        keys = [k.key for k in path]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = rng.standard_normal(decl.shape).astype(
            np.float32) / np.sqrt(decl.shape[-2])
    params["router"] *= 3.0
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    return cfgs[0], cfgs[1], params, x


def _torch_tree(params):
    return {k: (_torch_tree(v) if isinstance(v, dict) else _t(v))
            for k, v in params.items()}


def test_dispatch_plan_integers_exact():
    """top-k, ranks, keep and slots (drop bin E*C) equal the reference's
    at a capacity that drops tokens."""
    jcfg, tcfg, params, x = _moe_case()
    want = jffn._dispatch_plan(jnp.asarray(x), jnp.asarray(params["router"]),
                               jcfg.moe)
    got = tffn._dispatch_plan(_t(x), _t(params["router"]), tcfg.moe)
    probs, top_p, top_e, keep, slot, C = want
    assert got[5] == C and C == tffn._capacity(x.shape[1], tcfg.moe)
    assert not np.asarray(keep).all()           # some entries dropped
    top_pj = np.asarray(top_p)
    srt = np.sort(np.asarray(probs), -1)[..., ::-1]
    K = tcfg.moe.top_k
    assert (srt[..., :K] > srt[..., 1:K + 1]).all()   # no ties in top-k
    for name, g, w in (("top_e", got[2], top_e), ("keep", got[3], keep),
                       ("slot", got[4], slot)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    assert int(got[4].max()) <= tcfg.moe.n_experts * C
    # the router's logits sum in another order: a few f32 ulps through exp
    np.testing.assert_allclose(got[0].numpy(), np.asarray(probs),
                               rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), top_pj, rtol=1e-5)


@pytest.mark.parametrize("group", [None, 8])
def test_moe_forward(monkeypatch, group):
    """Output and aux at f32 tolerance, with tokens dropped, with and
    without the split into dispatch groups (S > MOE_GROUP_TOKENS)."""
    if group is not None:
        monkeypatch.setattr(jffn, "MOE_GROUP_TOKENS", group)
        monkeypatch.setattr(tffn, "MOE_GROUP_TOKENS", group)
    jcfg, tcfg, params, x = _moe_case()
    want, want_aux = jffn.moe_forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jcfg, NULL_CTX)
    p = _torch_tree(params)
    got, aux = tffn.moe_forward(p, _t(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)

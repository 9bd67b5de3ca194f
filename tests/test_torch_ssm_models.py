"""The port's ssm and hybrid families (``repro_torch.models.{mamba2,rwkv6,
zamba2}``) held against the JAX reference (``repro.models``) on the same
parameters and the same numpy inputs, on the CPU.

As in ``tests/test_torch_models.py``: the reference initialises each
smoke model with its own ``init`` (``jax.random.key(0)``), the norm
parameters are then drawn (std 0.1 about their constants), and the tree
crosses into the port through ``convert.lm_params_from_arrays``.  One
module fixture a family runs the reference once: jitted forward + loss
for the f32 and the bf16 variant, then prefill and four decode steps in
bf16; for zamba2 also a prefill longer than its ring window (the wrap)
and four steps after it, for rwkv6 decode steps to three times past
``max_len``.

Bounds, those of ``tests/test_torch_models.py`` (median, p99, max of
|got - want| / max |want|): f32 logits (3e-5, 1e-2, 1e-1); bf16 logits
(2^-6, 0.1, 0.5); caches (1e-3, 2e-2, 0.1); losses rtol 1e-4 (f32) and
1e-2 (bf16); argmax equal at every f32 position and at 90% of the bf16
ones (decode steps: 50%), every other one a tie its own row's error
explains.  The mechanism is the same: the reference's init makes the
shared attention block nearly one-hot and the recurrent state carries a
rounding step on, so a one-ulp difference in a bf16 projection can move
later positions; layer by layer, teacher-forced, the two agree to one
bf16 ulp.  Cache lengths and ring positions are exact; the conv and
mamba pieces on moderate random inputs are held to a few f32 ulps, and
bf16 ``_causal_conv`` (the reference's order of shifted adds) exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.models import mamba2 as jmamba
from repro.models.base import NULL_CTX
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_arrays, lm_params_from_arrays
from repro_torch.models import RWKV6LM, Zamba2LM, build
from repro_torch.models import mamba2 as tmamba
from repro_torch.models.base import leaves
from test_torch_models import (ARGMAX_SHARE, BF16_BOUNDS, CACHE_BOUNDS,
                               F32_BOUNDS, LOSS_RTOL, _argmax_agrees, _close,
                               _np, _t)

SSM_ARCHS = ["rwkv6-7b", "zamba2-7b"]
B, S, MAX_LEN, DECODE_STEPS = 2, 48, 64, 4
WRAP_MAX_LEN = 24           # zamba2: a ring of 24 slots under 48 tokens
LONG_MAX_LEN, LONG_STEPS = 8, 24    # rwkv6: 3x past max_len
NORM_LEAVES = ("gamma", "beta", "ln", "ln_in", "ln_mlp", "final_norm",
               "norm")
RTOL_PIECES = 2e-6


def _perturb_norms(tree, seed=0):
    """Every norm scale and shift drawn about its constant (std 0.1)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (v + 0.1 * rng.standard_normal(v.shape).astype(
                        v.dtype) if k in NORM_LEAVES
                        and not isinstance(v, dict) else walk(v))
                    for k, v in node.items()}
        return node
    return walk(tree)


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, n)).astype(np.int32)


def _positions(n, start=0):
    return np.ascontiguousarray(np.broadcast_to(
        np.arange(start, start + n, dtype=np.int32), (B, n)))


def _steps(cfg, n, start, seed=1):
    """n decode steps (tokens (B, 1), positions (B, 1)) from ``start``."""
    toks = _tokens(cfg, n, seed)
    return [(toks[:, t:t + 1], _positions(1, start + t)) for t in range(n)]


def _ref_decode(jmodel, params, tokens, max_len, steps):
    """The reference's prefill of ``tokens`` and its decode ``steps``:
    (prefill (logits, cache), [(logits, cache) a step])."""
    logits, cache = jax.jit(jmodel.prefill, static_argnums=3)(
        params, jnp.asarray(tokens), jnp.asarray(_positions(tokens.shape[1])),
        max_len)
    pre = (np.asarray(logits), _np(cache))
    step = jax.jit(jmodel.decode_step)
    out = []
    for tok, pos in steps:
        logits, cache = step(params, cache, jnp.asarray(tok),
                             jnp.asarray(pos))
        out.append((np.asarray(logits), _np(cache)))
    return pre, out


@pytest.fixture(scope="module", params=SSM_ARCHS)
def arch(request):
    """Everything the reference computes for one family."""
    name = request.param
    base = jconfigs.get_config(name).smoke()
    jmodel = jbuild(base)
    tree = _perturb_norms(_np(jmodel.init(jax.random.key(0))))
    params = jax.tree.map(jnp.asarray, tree)
    tokens = _tokens(base, S, 0)
    out = dict(name=name, tree=tree, tokens=tokens)
    for dt in ("float32", "bfloat16"):
        m = jbuild(dataclasses.replace(base, dtype=dt))

        def fwd_loss(p, t, m=m):
            logits, aux = m.forward(p, t, jnp.asarray(_positions(S)))
            return logits, aux, m.loss(p, {"tokens": t})
        out[dt] = _np(jax.jit(fwd_loss)(params, jnp.asarray(tokens)))
    out["decode"] = _ref_decode(jmodel, params, tokens, MAX_LEN,
                                _steps(base, DECODE_STEPS, S))
    if name == "zamba2-7b":
        out["wrap"] = _ref_decode(jmodel, params, tokens, WRAP_MAX_LEN,
                                  _steps(base, DECODE_STEPS, S, seed=2))
    else:
        short = tokens[:, :LONG_MAX_LEN]
        out["long"] = _ref_decode(jmodel, params, short, LONG_MAX_LEN,
                                  _steps(base, LONG_STEPS, LONG_MAX_LEN,
                                         seed=3))
    return out


def _port(arch, dtype):
    cfg = dataclasses.replace(tconfigs.get_config(arch["name"]).smoke(),
                              dtype=dtype)
    return lm_params_from_arrays(cfg, arch["tree"], device="cpu")


def _check_cache(name, cache, want):
    """Every leaf: the reference's dtype, ints exact, floats within
    CACHE_BOUNDS."""
    got, want = dict(leaves(cache)), dict(leaves(want))
    assert set(got) == set(want), name
    for path, w in want.items():
        g = got[path]
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (name, path)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
        else:
            _close(f"{name} {path}", g.float(), w, CACHE_BOUNDS)


def _run_decode(name, model, tokens, max_len, steps, want):
    """The port's prefill and steps against the reference's ``want``."""
    (want_logits, want_cache), want_steps = want
    logits, cache = model.prefill(_t(tokens), _t(_positions(tokens.shape[1])),
                                  max_len)
    _close(f"{name} prefill logits", logits, want_logits, BF16_BOUNDS)
    _check_cache(f"{name} prefill", cache, want_cache)
    for t, ((tok, pos), (want_logits, want_cache)) in enumerate(
            zip(steps, want_steps)):
        before = {k: v.data_ptr() for k, v in leaves(cache)}
        logits, out = model.decode_step(cache, _t(tok), _t(pos))
        assert out is cache
        assert {k: v.data_ptr() for k, v in leaves(cache)} == before, \
            f"{name}: decode step {t} did not write the cache in place"
        _close(f"{name} decode {t} logits", logits, want_logits,
               BF16_BOUNDS)
        _argmax_agrees(f"{name} decode {t}", logits, want_logits, 0.5)
        _check_cache(f"{name} decode {t}", cache, want_cache)


# -- builds, declarations ----------------------------------------------------

def test_build_dispatches_as_the_reference():
    for name, cls in (("rwkv6-7b", RWKV6LM), ("zamba2-7b", Zamba2LM)):
        model = build(tconfigs.get_config(name), device="meta")
        assert type(model) is cls
        assert type(jbuild(jconfigs.get_config(name))).__name__ == \
            cls.__name__
    assert build(tconfigs.get_config("rwkv6-7b"),
                 device="meta").n_params() == 7_577_026_560
    assert build(tconfigs.get_config("zamba2-7b"),
                 device="meta").n_params() == 6_916_795_728
    z = build(tconfigs.get_config("zamba2-7b"), device="meta")
    assert z.n_invocations == 13 and len(z.groups()) == 14
    assert [len(r) for r, _ in z.groups()] == [6] * 13 + [3]


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_default_device_is_the_card(name):
    """Built with no device the model is meant for ``cuda``: without a
    card it raises, as every entry point of the port does."""
    if torch.cuda.is_available():
        assert build(tconfigs.get_config(name).smoke()).device.type == \
            "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            build(tconfigs.get_config(name).smoke())


@pytest.mark.parametrize("name", SSM_ARCHS)
def test_cache_axes_mirror_the_reference(name):
    model = build(tconfigs.get_config(name).smoke(), device="cpu")
    want = jbuild(jconfigs.get_config(name).smoke()).cache_axes()
    assert model.cache_axes() == want
    cache = model.init_cache(B, MAX_LEN)
    jcache = jbuild(jconfigs.get_config(name).smoke()).init_cache(B, MAX_LEN)
    got, ref = dict(leaves(cache)), dict(leaves(_np(jcache)))
    assert set(got) == set(ref) == set(dict(leaves(model.cache_axes())))
    for k, v in ref.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      v.astype(np.float32))


# -- forward, loss, prefill, decode ------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss(arch, dtype):
    model = _port(arch, dtype)
    tokens = arch["tokens"]
    want_logits, want_aux, (want_loss, want_metrics) = arch[dtype]
    logits, aux = model.forward(_t(tokens), _t(_positions(S)))
    _close("logits", logits, want_logits,
           F32_BOUNDS if dtype == "float32" else BF16_BOUNDS)
    _argmax_agrees("logits", logits, want_logits,
                   1.0 if dtype == "float32" else ARGMAX_SHARE)
    assert float(aux) == float(want_aux) == 0.0
    loss, metrics = model.loss({"tokens": _t(tokens)})
    np.testing.assert_allclose(float(loss), want_loss,
                               rtol=LOSS_RTOL[dtype])
    for k in ("ce", "zloss"):
        np.testing.assert_allclose(float(metrics[k]), want_metrics[k],
                                   rtol=LOSS_RTOL[dtype])


def test_prefill_and_decode(arch):
    """Prefill's last logits and every cache leaf, then four decode steps'
    logits and caches (written in place), in the shipped bf16."""
    model = _port(arch, "bfloat16")
    _run_decode(arch["name"], model, arch["tokens"], MAX_LEN,
                _steps(model.cfg, DECODE_STEPS, S), arch["decode"])


def test_ring_wrap_and_long_decode(arch):
    """zamba2: a 48-token prompt into a ring of 24 slots keeps positions
    24..47 at pos % 24 and decodes over the wrapped ring; rwkv6: decode to
    three times past max_len (its state is O(1))."""
    model = _port(arch, "bfloat16")
    if arch["name"] == "zamba2-7b":
        _run_decode("zamba2 wrap", model, arch["tokens"], WRAP_MAX_LEN,
                    _steps(model.cfg, DECODE_STEPS, S, seed=2),
                    arch["wrap"])
        _, cache = model.prefill(_t(arch["tokens"]), _t(_positions(S)),
                                 WRAP_MAX_LEN)
        pos = cache["attn"]["pos"].numpy()
        assert pos.shape[-1] == WRAP_MAX_LEN
        want = np.arange(S - WRAP_MAX_LEN, S)
        np.testing.assert_array_equal(pos[..., want % WRAP_MAX_LEN],
                                      np.broadcast_to(want, pos.shape))
    else:
        _run_decode("rwkv6 long", model, arch["tokens"][:, :LONG_MAX_LEN],
                    LONG_MAX_LEN, _steps(model.cfg, LONG_STEPS,
                                         LONG_MAX_LEN, seed=3),
                    arch["long"])


def test_hidden_is_the_stack_before_the_final_norm(arch):
    model = _port(arch, "float32")
    tokens = _t(arch["tokens"])
    x, aux = model.hidden(tokens, _t(_positions(S)))
    assert x.shape == (B, S, model.cfg.d_model) and float(aux) == 0.0
    torch.testing.assert_close(model.logits(x),
                               model.forward(tokens, _t(_positions(S)))[0],
                               rtol=0, atol=0)


def test_round_trip_is_exact(arch):
    """``lm_arrays`` gives the reference's tree back leaf for leaf
    (zamba2's unstacked ``shared_attn`` beside the stacked layers); a
    missing leaf is refused."""
    model = _port(arch, "float32")
    back = lm_arrays(model)
    want = dict(leaves(arch["tree"]))
    got = dict(leaves(back))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=str(k))
    tree = dict(arch["tree"])
    tree.pop("lm_head")
    with pytest.raises(ValueError, match="lm_head"):
        lm_params_from_arrays(tconfigs.get_config(arch["name"]).smoke(),
                              tree, device="cpu")


# -- the mamba pieces ---------------------------------------------------------

def _mamba_case(seed=5):
    cfg_j = jconfigs.get_config("zamba2-7b").smoke()
    cfg_t = tconfigs.get_config("zamba2-7b").smoke()
    rng = np.random.default_rng(seed)
    p = {}
    for k, d in jmamba.decls_mamba(cfg_j).items():
        p[k] = (rng.standard_normal(d.shape) * (0.5 if d.init == "small"
                                                else 0.2)).astype(np.float32)
    return cfg_j, cfg_t, p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S_", [2, 19])
def test_causal_conv(dtype, S_):
    """Shifted adds in the reference's order: bit for bit in bf16 (S below
    and above the conv width), a few ulps in f32."""
    rng = np.random.default_rng(S_)
    x = rng.standard_normal((2, S_, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jax.jit(jmamba._causal_conv)(
        jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(b)
    ).astype(jnp.float32))
    got = tmamba._causal_conv(_t(x).to(getattr(torch, dtype)), _t(w),
                              _t(b)).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL_PIECES,
                                   atol=RTOL_PIECES)


def test_mamba_forward_prefill_and_decode():
    """f32: prefill's output, conv tail (left-padded under the conv width)
    and SSM state, then three decode steps through the (B, W, C) window,
    each against the reference on the same state."""
    cfg_j, cfg_t, p = _mamba_case()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    rng = np.random.default_rng(6)
    jfwd = jax.jit(lambda p, x, st: jmamba.mamba_forward(
        p, x, cfg_j, NULL_CTX, state=st))
    for S_ in (2, 21):
        x = rng.standard_normal((2, S_, cfg_j.d_model)).astype(np.float32)
        want, wst = jfwd(jp, jnp.asarray(x), None)
        got, st = tmamba.mamba_forward(tp, _t(x), cfg_t)
        tol = dict(rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
        for k in ("conv", "s"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(wst[k]),
                                       **tol)
        for _ in range(3):
            x1 = rng.standard_normal((2, 1, cfg_j.d_model)).astype(
                np.float32)
            want, wst = jfwd(jp, jnp.asarray(x1), wst)
            got, st = tmamba.mamba_forward(tp, _t(x1), cfg_t, state=st)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
            for k in ("conv", "s"):
                np.testing.assert_allclose(st[k].numpy(),
                                           np.asarray(wst[k]), **tol)


def test_mamba_dims_equal_the_reference():
    for name in ("zamba2-7b",):
        for cfg_j, cfg_t in ((jconfigs.get_config(name),
                              tconfigs.get_config(name)),
                             (jconfigs.get_config(name).smoke(),
                              tconfigs.get_config(name).smoke())):
            assert tmamba.mamba_dims(cfg_t) == jmamba.mamba_dims(cfg_j)
    full = tmamba.mamba_dims(tconfigs.get_config("zamba2-7b"))
    assert full == dict(d_inner=7168, n_heads=112, conv_ch=7424,
                        d_in_proj=14704)

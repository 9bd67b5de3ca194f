"""The port's LM training step (``repro_torch.train.step``,
``repro_torch.models`` under autograd) held against the JAX reference
(``repro.train.step``) on the same parameters and numpy inputs, on the
CPU.

The reference initialises each smoke model with ``jax.random.key(0)``;
every leaf its init sets to a constant (norm scales and shifts, rwkv6's
mixes and decay base, mamba's ``dt_bias`` / ``a_log`` / ``d_skip``) is
drawn instead (std 0.1 about it), so that a gradient that reads such a
leaf wrongly shows.  The tree crosses into the port as f32 master
tensors; the reference's gradient is ``jax.value_and_grad(lambda p, b:
model.loss(cast_tree(p, cfg.dtype), b))``, the port's
``step.backward_into`` (the cast once, the model on the cast tree,
backward into the masters).

Tolerances.  In f32 compute both packages still round q, k, v, the
attention probabilities and their cotangents to bf16, as the reference
does; each op's gradient agrees to an ulp (attention's backward alone is
bitwise equal on these inputs), but over a model the f32 sums in another
order move some of those roundings by one bf16 ulp, and every rounding
downstream carries it on.  The gradients are that sensitive in the port
itself: a one-ulp perturbation of the f32 parameters moves a leaf's
gradient by up to 1.3e-3 (llama3) and 2.4e-3 (deepseek) in relative
Frobenius norm (``test_f32_grads_move_under_one_ulp``).  Measured against
the reference: rwkv6 (no bf16 rounding on its f32 path) 2.3e-5, gemma
9.5e-7, deepseek 3.4e-4, llama3 8.5e-4, zamba2 5.6e-3 (its 13 shared
attention passes a step); loss 8.2e-6 or less.  So the f32 bound is
1e-4 for rwkv6 and 1e-2 for the models with attention, and the loss
1e-5.  In bf16 compute the gradients are far more sensitive (half a bf16
ulp of random perturbation moves them by 0.3-1.4); measured: loss 4.4e-4,
leaf Frobenius up to 0.23 (deepseek's router: a top-k that ties), median
elementwise error relative to the leaf's largest 2.6e-2.  Bounds: loss
1e-3, Frobenius 0.5, median 5e-2 (a gradient read from the wrong place
is off by its own scale).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.train import AdamWConfig as JAdamW
from repro.train import init_state as jinit_state
from repro.train import make_train_step as jmake_train_step
from repro.train.step import cast_tree as jcast_tree
from repro_torch import configs as tconfigs
from repro_torch.convert import (_tensor, train_state_arrays,
                                 train_state_from_arrays)
from repro_torch.models import build
from repro_torch.models.base import leaves
from repro_torch.train import (AdamWConfig, cast_tree, init_state,
                               make_train_step)
from repro_torch.train.step import backward_into

GRAD_ARCHS = ["llama3-8b", "deepseek-v2-lite-16b", "rwkv6-7b", "zamba2-7b",
              "gemma-7b"]
B, S = 2, 32
F32_FROB = {"rwkv6-7b": 1e-4}      # no bf16 rounding on its f32 path
F32_FROB_ATTN = 1e-2
F32_LOSS_RTOL = 1e-5
BF16_LOSS_RTOL, BF16_FROB, BF16_MEDIAN = 1e-3, 0.5, 5e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _draw_constants(tree, seed=0):
    """Every leaf that the init set to one constant gets std-0.1 draws
    about it."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if np.all(node == node.flat[0]):
            return (node + 0.1 * rng.standard_normal(node.shape)).astype(
                node.dtype)
        return node
    return walk(tree)


def _tokens(cfg, seed=1, shape=(B, S)):
    rng = np.random.default_rng(seed)
    if cfg.modality == "audio":
        shape = shape + (cfg.n_codebooks,)
    return rng.integers(0, cfg.vocab, shape).astype(np.int32)


def _batch(cfg, tokens):
    b = {"tokens": tokens}
    if cfg.rope_style == "mrope":
        Bt, St = tokens.shape[-2:] if tokens.ndim == 2 else tokens.shape[:2]
        b["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(St, dtype=np.int32), (3, Bt, St)))
    return b


def _masters(tree):
    return jax.tree.map(lambda a: _tensor(a).requires_grad_(), tree)


def _port_grads(name, dtype, tree, batch, **cfg_changes):
    cfg = dataclasses.replace(tconfigs.get_config(name).smoke(), dtype=dtype,
                              **cfg_changes)
    masters = _masters(tree)
    loss = backward_into(build(cfg, device="meta"), masters,
                         {k: torch.as_tensor(v) for k, v in batch.items()})
    return float(loss), {p: (m.grad.numpy() if m.grad is not None
                             else np.zeros(m.shape, np.float32))
                         for p, m in leaves(masters)}


@pytest.fixture(scope="module", params=GRAD_ARCHS)
def ref(request):
    """The reference's loss and gradients for one architecture, f32 and
    bf16 compute."""
    name = request.param
    base = jconfigs.get_config(name).smoke()
    tree = _draw_constants(_np(jbuild(base).init(jax.random.key(0))))
    batch = _batch(base, _tokens(base))
    out = dict(name=name, tree=tree, batch=batch)
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dt)
        m = jbuild(cfg)
        f = jax.jit(jax.value_and_grad(
            lambda p, b, m=m, cfg=cfg: m.loss(jcast_tree(p, cfg.dtype),
                                              b)[0]))
        loss, g = f(tree, {k: jnp.asarray(v) for k, v in batch.items()})
        out[dt] = (float(loss), dict(leaves(_np(g))))
    return out


def _rel_frob(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_loss_and_grads_f32(ref):
    loss, grads = _port_grads(ref["name"], "float32", ref["tree"],
                              ref["batch"])
    want_loss, want = ref["float32"]
    assert abs(loss - want_loss) <= F32_LOSS_RTOL * abs(want_loss)
    assert set(grads) == set(want)
    bound = F32_FROB.get(ref["name"], F32_FROB_ATTN)
    for path, w in want.items():
        assert grads[path].shape == w.shape, path
        rel = _rel_frob(grads[path], w)
        assert rel <= bound, f"{path}: rel Frobenius {rel:.2e} > {bound}"


def test_loss_and_grads_bf16(ref):
    loss, grads = _port_grads(ref["name"], "bfloat16", ref["tree"],
                              ref["batch"])
    want_loss, want = ref["bfloat16"]
    assert abs(loss - want_loss) <= BF16_LOSS_RTOL * abs(want_loss)
    for path, w in want.items():
        g = grads[path]
        rel = _rel_frob(g, w)
        med = np.median(np.abs(g - w)) / max(np.abs(w).max(), 1e-30)
        assert rel <= BF16_FROB, f"{path}: rel Frobenius {rel:.2e}"
        assert med <= BF16_MEDIAN, f"{path}: median rel err {med:.2e}"


def test_f32_grads_move_under_one_ulp():
    """Why the f32 bound of the attention models is not 1e-4: a one-ulp
    perturbation of llama3's f32 parameters moves the port's own
    gradients by more than that (bf16 roundings of q, k, v, the
    probabilities and their cotangents flip)."""
    cfg = jconfigs.get_config("llama3-8b").smoke()
    tree = _draw_constants(_np(jbuild(cfg).init(jax.random.key(0))))
    batch = _batch(cfg, _tokens(cfg))
    rng = np.random.default_rng(5)
    nudged = jax.tree.map(lambda a: (a * (1 + rng.choice([-1, 1], a.shape)
                                          * 2.0 ** -23)).astype(np.float32),
                          tree)
    _, g0 = _port_grads("llama3-8b", "float32", tree, batch)
    _, g1 = _port_grads("llama3-8b", "float32", nudged, batch)
    worst = max(_rel_frob(g1[p], g0[p]) for p in g0)
    assert 1e-4 < worst < F32_FROB_ATTN, worst


def test_cast_once_sums_cotangents_in_compute_dtype():
    """A leaf used twice (gemma's tied embedding, zamba2's shared block):
    cast once, its two bf16 cotangents add in bf16 and the sum is cast to
    f32, bit for bit as the reference's grad of ``cast_tree``; a cast at
    each use would add them in f32, a different number here."""
    rng = np.random.default_rng(0)
    p = rng.standard_normal(4096).astype(np.float32)
    x1, x2 = (rng.standard_normal(4096).astype(np.float32) for _ in range(2))

    def jloss(tree):
        w = jcast_tree(tree, jnp.bfloat16)["w"]
        return (jnp.sum((w * x1.astype(jnp.bfloat16)).astype(jnp.float32))
                + jnp.sum((w * x2.astype(jnp.bfloat16)).astype(jnp.float32)))
    want = np.asarray(jax.grad(jloss)({"w": p})["w"])

    def tloss(w):
        return ((w * torch.from_numpy(x1).bfloat16()).float().sum()
                + (w * torch.from_numpy(x2).bfloat16()).float().sum())
    master = torch.from_numpy(p.copy()).requires_grad_()
    tloss(cast_tree({"w": master}, torch.bfloat16)["w"]).backward()
    np.testing.assert_array_equal(master.grad.numpy(), want)

    per_use = torch.from_numpy(p.copy()).requires_grad_()
    ((per_use.bfloat16() * torch.from_numpy(x1).bfloat16()).float().sum()
     + (per_use.bfloat16() * torch.from_numpy(x2).bfloat16()).float().sum()
     ).backward()
    assert not np.array_equal(per_use.grad.numpy(), want)


@pytest.mark.parametrize("name", ["llama3-8b", "deepseek-v2-lite-16b",
                                  "rwkv6-7b", "zamba2-7b"])
def test_remat_gives_the_same_grads(name):
    """Each layer recomputed in the backward (``cfg.remat``, under
    ``torch.utils.checkpoint``) gives the gradients of the run that keeps
    its activations, bit for bit."""
    cfg = tconfigs.get_config(name).smoke()
    model = build(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    tree = jax.tree.map(lambda t: t.numpy(), model.tree())
    batch = _batch(cfg, _tokens(cfg, seed=4))
    out = [_port_grads(name, "float32", tree, batch, remat=r)
           for r in (False, True)]
    assert out[0][0] == out[1][0]
    for path, g in out[0][1].items():
        np.testing.assert_array_equal(out[1][1][path], g, err_msg=str(path))


def test_train_step_accum2_matches_reference():
    """Three steps of two microbatches each: the port's ``train_step``
    against the reference's (jitted) on the same state and batches.
    rwkv6 in f32, whose path rounds nothing to bf16: on llama3 the
    one-ulp sensitivity above (1e-3) meets Adam's first step, which moves
    each parameter by lr x the sign of its gradient, and tiny gradient
    elements that differ in sign take the two runs apart (m 3.4% apart
    after three steps).  Measured here: loss 3.2e-7, grad norm 3.2e-5,
    lr equal; params 4.2e-5, m 1.3e-4, v 1.9e-4 in relative Frobenius
    norm."""
    name = "rwkv6-7b"
    cfg = dataclasses.replace(jconfigs.get_config(name).smoke(),
                              dtype="float32")
    jmodel = jbuild(cfg)
    tree = _draw_constants(_np(jmodel.init(jax.random.key(0))))
    opt = dict(lr=3e-3, warmup_steps=2, weight_decay=0.1)
    jstate = jinit_state(jax.tree.map(jnp.asarray, tree), JAdamW(**opt))
    jstep = jax.jit(jmake_train_step(jmodel, JAdamW(**opt)))
    tcfg = dataclasses.replace(tconfigs.get_config(name).smoke(),
                               dtype="float32")
    tstate = train_state_from_arrays(_np(jstate), device="cpu")
    tstep = make_train_step(build(tcfg, device="meta"), AdamWConfig(**opt),
                            device="cpu")
    for i in range(3):
        tokens = _tokens(cfg, seed=10 + i, shape=(2, B, S))
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)}, i)
        tstate, tm = tstep(tstate, {"tokens": tokens}, i)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
    got = train_state_arrays(tstate)
    want = _np(jstate)
    assert int(got["step"]) == int(want.step) == 3
    for part in ("params", "m", "v"):
        for (path, g), (_, w) in zip(leaves(got[part]),
                                     leaves(getattr(want, part))):
            rel = _rel_frob(g, w)
            assert rel <= 1e-3, f"{part} {path}: rel Frobenius {rel:.2e}"


@pytest.mark.parametrize("name", jconfigs.ARCH_IDS)
def test_train_step_reduces_loss(name):
    """The reference's smoke test (``tests/test_models.py``) on the port:
    eight steps on one repeated batch (B = 2, S = 32, accum 1) reduce the
    loss by more than 0.1."""
    cfg = tconfigs.get_config(name).smoke()
    model = build(cfg, device="cpu")
    opt = AdamWConfig(lr=3e-3, warmup_steps=1, weight_decay=0.0)
    state = init_state(model.init(torch.Generator().manual_seed(0)).tree(),
                       opt)
    step = make_train_step(model, opt, device="cpu")
    batch = {k: v[None] for k, v in
             _batch(cfg, _tokens(cfg, seed=2)).items()}
    losses = []
    for i in range(8):
        state, metrics = step(state, batch, 1)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0] - 0.1, losses


@pytest.mark.parametrize("name", ["llama3-8b", "rwkv6-7b", "zamba2-7b"])
def test_serving_after_training_builds_no_graph(name):
    """Trained for two steps, the weights loaded back into the model: its
    ``prefill`` and ``decode_step`` (and ``forward`` on its own
    parameters) build no autograd graph, with grad mode on."""
    cfg = tconfigs.get_config(name).smoke()
    model = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    opt = AdamWConfig(lr=3e-3, warmup_steps=1)
    state = init_state(model.tree(), opt)
    step = make_train_step(model, opt, device="cpu")
    batch = {"tokens": _tokens(cfg, seed=3)[None]}
    for i in range(2):
        state, _ = step(state, batch, i)
    model.load_tree(state.params)
    for path, p in leaves(model.tree()):
        np.testing.assert_array_equal(
            p.numpy(), dict(leaves(state.params))[path].detach().numpy())
    assert torch.is_grad_enabled()
    tokens = torch.as_tensor(_tokens(cfg, seed=4))
    positions = torch.arange(S)[None].expand(B, S)
    logits, cache = model.prefill(tokens, positions, max_len=S + 2)
    outs = [logits] + [t for _, t in leaves(cache)]
    logits, cache = model.decode_step(cache, tokens[:, :1],
                                      positions[:, :1] + S)
    outs += [logits] + [t for _, t in leaves(cache)]
    outs.append(model.forward(tokens, positions)[0])
    for t in outs:
        assert t.grad_fn is None and not t.requires_grad


def test_sharded_step_needs_both_layouts():
    """A ZeRO step takes the moments' and the parameters' layouts
    together (``tests/test_torch_zero.py`` runs it on a mesh)."""
    model = build(tconfigs.get_config("llama3-8b").smoke(), device="meta")
    with pytest.raises(ValueError, match="both"):
        make_train_step(model, AdamWConfig(), grad_shardings={},
                        device="cpu")
    with pytest.raises(ValueError, match="both"):
        make_train_step(model, AdamWConfig(), param_shardings={},
                        device="cpu")

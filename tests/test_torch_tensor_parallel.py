"""The port's tensor-parallel compute over the model axis for the
transformer family (``repro_torch.models`` built with a ``ShardCtx`` on a
mesh; ``train.step.ShardedStep``), with its three explicit legs
(context-parallel ``chunked_attention``, the head_dim leg of
``decode_attention``, expert-parallel ``_routed_ep``), in one gloo world
of 4 on the CPU, held to the port's one device and to the reference.

A module fixture writes the numpy inputs and spawns the world
(``launch.mesh.spawn``, file rendezvous; the rank program is
``tests/_torch_tp_ranks.py``), which builds the (2, 2) and (1, 4) meshes;
meanwhile this process runs the reference on the same inputs: the
forward and the prefill of each case in f32, and ``chunked_attention`` /
``decode_attention`` at ``tests/test_sharding.py``'s shapes on one
device.

Cases: the reference's smoke configs of llama3-8b, deepseek-v2-lite-16b,
qwen2-vl-2b (vision ``extra_embeds``, M-RoPE) and starcoder2-3b, and two
variants: starcoder2 with 6 heads (context-parallel attention inside a
model on (1, 4)) and deepseek with 6 experts (the expert hidden dim
takes the model axis on (1, 4)).  On (1, 4) the 2 KV heads take the
head_dim decode leg and 4 experts are expert parallel.

Weights: the reference's init (``jax.random.key(0)``), its constant
leaves drawn (``test_torch_train_step._draw_constants``), and ``wq``,
``wk`` and MLA's ``w_uk`` scaled by 1/16, as ``chip_smoke.py`` phases 14
(b) and 15 (b) scale them.  Under the reference's init the attention
logits have a std of 10-20 at d = 64, so the softmax is nearly one-hot
and a one-ulp difference (tensor-parallel sums run in another order)
flips a bf16 rounding of q or k that the softmax then carries far;
scaled, the attention logits are of order one.

Bounds.  The logits of the forward, the prefill and every decode step
against the port's one device: the median of |got - want| / max |want|
within 1e-6 (measured 1.2e-8 to 8.8e-8: f32 rounding), and the whole
within 1e-4 in relative Frobenius norm (measured 9.4e-8 to 3.5e-5).  The
two packages round v and the attention probabilities to bf16 as the
reference does, so a one-ulp f32 difference in a layer's input flips
one such rounding now and then, and the positions it reaches move by up
to 1.2e-4 of the largest logit, as a one-ulp perturbation of the
one-device model's own f32 weights moves them.  Against the reference:
``tests/test_torch_models.py``'s f32 bounds.  The decode steps' greedy
tokens equal one device's; the train step at ``tests/test_torch_zero.py``'s
bounds; the attention legs within 2e-2 of the reference
(``tests/test_sharding.py``) and within 1e-6 (context parallel) or 1e-5
relative (head_dim decode) of the port's one device.  Shards that the
mesh replicates are equal bit for bit.
"""
import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.models import attention as jattn
from repro.models import build as jbuild
from repro.models.base import NULL_CTX as JNULL_CTX
from repro_torch import configs as tconfigs
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import spawn
from repro_torch.models import ShardCtx, build
from repro_torch.models.base import leaves
from repro_torch.sharding import layout
from repro_torch.sharding.rules import merged_rules, opt_rules, param_rules

import _torch_tp_ranks as ranks
from test_torch_models import F32_BOUNDS, _close
from test_torch_train_step import _draw_constants, _np, _rel_frob

WORLD = 4
TP_MEDIAN, TP_FROB, CP_ABS, DEC_REL, REF_ABS = 1e-6, 1e-4, 1e-6, 1e-5, 2e-2
LOSS_RTOL, FROB, V_FROB = 1e-5, 1e-2, 2e-2
SOFTEN = 1 / 16
CASES = [(c, s) for c in ranks.CASES for s in ranks.MESHES]
IDS = [f"{c}-{ranks.mesh_tag(s)}" for c, s in CASES]


class FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)


def _jconfig(case):
    arch, changes = ranks.CASES[case]
    return ranks.change(dataclasses.replace(
        jconfigs.get_config(arch).smoke(), dtype="float32"), changes)


def _soften(tree):
    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if name in ("wq", "wk", "w_uk"):
            return (node * SOFTEN).astype(node.dtype)
        return node
    return walk(tree)


def _batch(cfg, rng, lead=()):
    """tokens (B, S), positions ((3,) B, S_IMG + S for M-RoPE) and
    (vlm) patch embeddings, with ``lead`` in front of each."""
    B, S, n = ranks.B, ranks.S, ranks.S_IMG
    out = {"tokens": rng.integers(0, cfg.vocab, lead + (B, S)).astype(
        np.int32)}
    if cfg.rope_style == "mrope":
        grid = np.stack([np.zeros(n), np.arange(n) // 4, np.arange(n) % 4])
        text = np.broadcast_to(np.arange(S) + 4, (3, S))
        pos = np.concatenate([grid, text], 1).astype(np.int32)
        out["positions"] = np.ascontiguousarray(
            np.broadcast_to(pos[:, None], lead + (3, B, n + S)))
        out["extra_embeds"] = rng.standard_normal(
            lead + (B, n, cfg.d_model)).astype(np.float32)
    else:
        out["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(S, dtype=np.int32), lead + (B, S)))
    if not lead:
        return out
    return {k: v for k, v in out.items()
            if k != "positions" or cfg.rope_style == "mrope"}


def _reference(case, tree, batch, out):
    cfg = _jconfig(case)
    model = jbuild(cfg)
    params = jax.tree.map(jnp.asarray, tree)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, aux = jax.jit(model.forward)(params, b["tokens"],
                                         b["positions"],
                                         b.get("extra_embeds"))
    out[f"{case}/logits"] = np.asarray(logits)
    logits, _ = jax.jit(model.prefill, static_argnums=3)(
        params, b["tokens"], b["positions"], ranks.MAX_LEN,
        b.get("extra_embeds"))
    out[f"{case}/prefill"] = np.asarray(logits)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the world (in a thread) while this process runs the
    reference; -> (reference results, [each rank's results], tmp)."""
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    arrays, trees, batches = {}, {}, {}
    for case in ranks.CASES:
        cfg = _jconfig(case)
        trees[case] = _soften(_draw_constants(_np(jbuild(cfg).init(
            jax.random.key(0)))))
        for path, a in leaves(trees[case]):
            arrays[f"{case}/tree/{ranks.key(path)}"] = a
        batches[case] = _batch(cfg, rng)
        for k, v in batches[case].items():
            arrays[f"{case}/batch/{k}"] = v
        for k, v in _batch(cfg, rng, (1,)).items():
            arrays[f"{case}/train/{k}"] = v
    cp = [rng.normal(size=ranks.CP_SHAPE).astype(np.float32)
          for _ in range(3)]
    for n, a in zip("qkv", cp):
        arrays[f"cp/{n}"] = a
    Bd, Smax, Hkv, hd = ranks.DEC_SHAPE
    dec = dict(q=rng.normal(size=(Bd, 1, ranks.DEC_HQ, hd)),
               k=rng.normal(size=ranks.DEC_SHAPE),
               v=rng.normal(size=ranks.DEC_SHAPE))
    for n, a in dec.items():
        arrays[f"dec/{n}"] = a.astype(np.float32)
    arrays["dec/len"] = np.full((Bd,), ranks.DEC_LEN, np.int32)
    np.savez(tmp / "inputs.npz", **arrays)
    dry = ranks.start_dry(tmp, "_torch_tp_ranks")

    failed = []

    def run():
        try:
            spawn(ranks.tp_main, WORLD, str(tmp),
                  init_method=f"file://{tmp}/store")
        except BaseException as e:     # re-raised on the test's thread
            failed.append(e)
    thread = threading.Thread(target=run)
    thread.start()
    ref = {}
    try:
        for case in ranks.CASES:
            _reference(case, trees[case], batches[case], ref)
        q, k, v = map(jnp.asarray, cp)
        ref["cp"] = np.asarray(jattn.chunked_attention(
            q, k, v, scale=ranks.SCALE, q_chunk=ranks.CP_CHUNK,
            k_chunk=ranks.CP_CHUNK, ctx=JNULL_CTX))
        ref["dec"] = np.asarray(jattn.decode_attention(
            *(jnp.asarray(arrays[f"dec/{n}"]) for n in ("q", "k", "v",
                                                        "len")),
            scale=ranks.SCALE, ctx=None))
    finally:
        thread.join()
        dry.wait(timeout=600)
    if failed:
        raise failed[0]
    assert dry.returncode == 0, "the dry run failed"
    ref["dry"] = json.loads((tmp / "dry.json").read_text())
    return (ref, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)],
            tmp)


def _tag(case, shape):
    return f"{case}/{ranks.mesh_tag(shape)}"


def _one_device_close(name, got, want):
    """The median of |got - want| / max |want| within TP_MEDIAN and the
    relative Frobenius norm within TP_FROB (module docstring)."""
    assert got.shape == want.shape, name
    med = np.median(np.abs(got.astype(np.float64) - want)) / np.abs(
        want).max()
    assert med <= TP_MEDIAN, f"{name}: median rel err {med:.2e}"
    rel = _rel_frob(got, want)
    assert rel <= TP_FROB, f"{name}: rel Frobenius {rel:.2e}"


# -- the attention legs at the reference test's shapes ----------------------

def test_context_parallel_leg_at_the_reference_shapes(world):
    """(4, 256, 6, 16) on (1, 4): 6 heads do not divide the axis, so
    the q-chunk grid is split over it; every rank ends with the whole
    output."""
    ref, outs, _ = world
    for out in outs:
        assert int(out["cp/legs"]) == 1 and int(out["cp/records"]) == 1
        got = out["cp/got"]
        assert np.abs(got - ref["cp"]).max() < REF_ABS
        assert np.abs(got - outs[0]["cp/one"]).max() <= CP_ABS
        np.testing.assert_array_equal(got, outs[0]["cp/got"])


def test_head_dim_decode_leg_at_the_reference_shapes(world):
    """(4, 64, Hkv = 2, 16) with Hq = 4 on (1, 4): the KV heads do not
    divide the axis, the head_dim does; one all-reduce of the (B, Hkv, G,
    Smax) partial logits over the model axis, whether the caches come
    whole or as this rank's head_dim slice."""
    ref, outs, _ = world
    one = outs[0]["dec/one"]
    B, Smax, Hkv, _ = ranks.DEC_SHAPE
    G = ranks.DEC_HQ // Hkv
    for out in outs:
        for k in ("dec/got", "dec/got_local"):
            got = out[k]
            assert np.abs(got - ref["dec"]).max() < REF_ABS
            assert _rel_frob(got, one) <= DEC_REL
        reduces = [tuple(r) for r in out["dec/records"]
                   if r[0] == "all_reduce"]
        assert reduces == [("all_reduce", "model",
                            f"{B},{Hkv},{G},{Smax}")] * 2


# -- each case on each mesh -------------------------------------------------

@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_forward_matches_one_device_and_reference(world, case, shape):
    ref, outs, _ = world
    got = outs[0][f"{_tag(case, shape)}/logits"]
    _one_device_close(f"{case} logits", got, outs[0][f"one/{case}/logits"])
    _close(f"{case} TP logits vs reference", got, ref[f"{case}/logits"],
           F32_BOUNDS)
    if shape[0] == 1:           # the aux loss of the whole batch
        np.testing.assert_allclose(outs[0][f"{_tag(case, shape)}/aux"],
                                   outs[0][f"one/{case}/aux"], rtol=1e-5,
                                   atol=1e-9)


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_prefill_and_greedy_decode_match_one_device(world, case, shape):
    """The prefill's logits held to one device's and at the f32 bounds to
    the reference's; the 8 greedy decode steps feed the same tokens as
    one device's, and their logits are held to one device's."""
    ref, outs, _ = world
    out, tag = outs[0], _tag(case, shape)
    got = out[f"{tag}/prefill"]
    _one_device_close(f"{case} prefill", got, out[f"one/{case}/prefill"])
    _close(f"{case} TP prefill vs reference", got, ref[f"{case}/prefill"],
           F32_BOUNDS)
    np.testing.assert_array_equal(out[f"{tag}/fed"], out[f"one/{case}/fed"])
    assert out[f"{tag}/fed"].shape == (ranks.B, ranks.DECODE)
    _one_device_close(f"{case} decode", out[f"{tag}/decode"],
                      out[f"one/{case}/decode"])


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_train_step_matches_one_device(world, case, shape):
    """The ZeRO + TP step: loss within 1e-5, each gathered gradient within
    1e-2 in relative Frobenius norm, no parameter more than 2 lr (+ 1e-6)
    from one device's step, m within 1e-2 and v within 2e-2 (the bounds
    of ``tests/test_torch_zero.py``)."""
    _, outs, _ = world
    out, tag = outs[0], _tag(case, shape)
    one = f"one/{case}/split{ranks.split_rows(case, shape)}"
    assert bool(out[f"{tag}/blocks"])
    want = out[f"{one}/loss"]
    for loss in (out[f"{tag}/grads_loss"], out[f"{tag}/loss"]):
        assert abs(loss - want) <= LOSS_RTOL * abs(want), (loss, want)
    keys = [k[len(f"{one}/grads/"):] for k in out
            if k.startswith(f"{one}/grads/")]
    assert keys
    lr = ranks.OPT["lr"]
    for k in keys:
        rel = _rel_frob(out[f"{tag}/grads/{k}"], out[f"{one}/grads/{k}"])
        assert rel <= FROB, f"{k}: rel Frobenius {rel:.2e}"
        p, w = out[f"{tag}/params/{k}"], out[f"{one}/params/{k}"]
        gap = np.abs(p - w) / (2 * lr + 1e-6 * np.abs(w))
        assert gap.max() <= 1.0, f"{k}: {gap.max():.3f} x 2 lr"
        assert _rel_frob(out[f"{tag}/m/{k}"], out[f"{one}/m/{k}"]) <= FROB
        assert _rel_frob(out[f"{tag}/v/{k}"], out[f"{one}/v/{k}"]) <= V_FROB


def _specs(case, shape):
    cfg = ranks.config(case)
    mesh = FakeMesh(data=shape[0], model=shape[1])
    decls = build(cfg, device="meta").decls()
    p = ShardCtx(mesh, param_rules(mesh, zero3=cfg.zero3)).param_shardings(
        decls)
    o = ShardCtx(mesh, opt_rules(mesh)).param_shardings(decls)
    return {part: {ranks.key(k): s for k, s in leaves(t)}
            for part, t in (("params", p), ("m", o), ("v", o))}


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_replicated_shards_are_bitwise_equal(world, case, shape):
    """After the step, ranks that hold the same block of a leaf hold the
    same bits, and every rank reports the same loss."""
    _, outs, _ = world
    tag, i = _tag(case, shape), ranks.MESHES.index(shape)
    assert len({float(o[f"{tag}/loss"]) for o in outs}) == 1
    pairs = 0
    for part, specs in _specs(case, shape).items():
        for k, s in specs.items():
            held = {}
            for out in outs:
                at = dict(zip(("data", "model"), out["coordinate"][i]))
                mine = tuple(at[a] for a in ("data", "model")
                             if a not in s.replicated_axes)
                local = out[f"{tag}/local/{part}/{k}"]
                if mine in held:
                    np.testing.assert_array_equal(local, held[mine],
                                                  err_msg=f"{part} {k}")
                    pairs += 1
                held.setdefault(mine, local)
    assert pairs > 0


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_local_blocks_have_the_spec_shapes(world, case, shape):
    """Every weight a rank computes on is its block under ``ShardCtx(mesh,
    merged_rules(mesh))``; every cache leaf after the prefill is its block
    under ``cache_axes`` (its rows and its model-axis slice)."""
    _, outs, _ = world
    cfg, tag = ranks.config(case), _tag(case, shape)
    mesh = FakeMesh(data=shape[0], model=shape[1])
    ctx = ShardCtx(mesh, merged_rules(mesh))
    model = build(cfg, device="meta")
    full = dict(leaves(model.init_cache(ranks.B, ranks.MAX_LEN)))
    axes = dict(leaves(model.cache_axes()))
    prefix = f"{tag}/cache/"
    split = 0
    for out in outs:
        assert out[f"{tag}/bad_weights"].size == 0, out[f"{tag}/bad_weights"]
        got = {k[len(prefix):]: tuple(v) for k, v in out.items()
               if k.startswith(prefix)}
        assert set(got) == {ranks.key(p) for p in full}
        for path, t in full.items():
            want = ctx.sharding(t.shape, axes[path]).shard_shape(t.shape)
            assert got[ranks.key(path)] == want, (path, want)
            split += want != tuple(t.shape)
    assert split > 0


def _param_shapes(case, shape) -> set:
    """Each weight's shape, whole and as a rank's block (a stacked leaf's
    per-layer shapes)."""
    cfg = ranks.config(case)
    mesh = FakeMesh(data=shape[0], model=shape[1])
    ctx = ShardCtx(mesh, merged_rules(mesh))
    out = set()
    for path, p in leaves(build(cfg, device="meta").decls()):
        for s in (p.shape, ctx.sharding(p.shape, p.axes).shard_shape(
                p.shape)):
            out.add(",".join(map(str, s[1:] if path[0] == "layers"
                                 else s)))
    return out


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_no_weight_crosses_the_model_axis(world, case, shape):
    """``layout.record_traffic`` over a forward and over a prefill with
    its decode steps: collectives over the model axis carry activations
    only, never a tensor of a weight's shape (whole or a block)."""
    _, outs, _ = world
    tag = _tag(case, shape)
    weights = _param_shapes(case, shape)
    for out in outs:
        for rec in ("fwd_records", "decode_records"):
            recs = [tuple(r) for r in out[f"{tag}/{rec}"]]
            model = [r for r in recs if r[1] == "model"]
            assert model, rec
            assert not [r for r in model if r[2] in weights], rec


def _kv_leg(cfg, m: int) -> bool:
    hd = cfg.resolved_head_dim
    return cfg.mla is None and cfg.n_kv_heads % m != 0 and hd % m == 0


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_each_case_takes_the_references_legs(world, case, shape):
    """Context parallel where the heads do not divide the model axis,
    ``_routed_ep`` where the experts do, the expert hidden dim where they
    do not, and the head_dim decode leg (one all-reduce of (B, Hkv, G,
    Smax) a layer and step) where the KV heads do not divide it and the
    head_dim does."""
    _, outs, _ = world
    cfg, tag = ranks.config(case), _tag(case, shape)
    m = shape[1]
    cp, ep, moe_mlp = (int(x) for x in outs[0][f"{tag}/legs"])
    assert (cp > 0) == (cfg.n_heads % m != 0)
    assert (ep > 0) == (cfg.moe is not None and cfg.moe.n_experts % m == 0)
    assert (moe_mlp > 0) == (cfg.moe is not None
                             and cfg.moe.n_experts % m != 0)
    B_loc = ranks.B // shape[0]
    G = cfg.n_heads // cfg.n_kv_heads
    logits = ("all_reduce", "model",
              f"{B_loc},{cfg.n_kv_heads},{G},{ranks.MAX_LEN}")
    n = sum(tuple(r) == logits for r in outs[0][f"{tag}/decode_records"])
    assert n == (cfg.n_layers * ranks.DECODE if _kv_leg(cfg, m) else 0)


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_dry_run_bytes_equal_the_worlds(world, case, shape):
    """The dry run of the case on its mesh (``launch.dryrun.measure`` in a
    fake world of that shape, rank 0, on ``meta``): the bytes its
    prefill, one decode step and the train step send over each mesh axis
    equal, exactly, what every rank of this gloo world counted."""
    ref, outs, _ = world
    tag = _tag(case, shape)
    for kind in ("prefill", "decode", "train"):
        prefix = f"{tag}/bytes/{kind}/"
        for out in outs:
            got = {k[len(prefix):]: float(v) for k, v in out.items()
                   if k.startswith(prefix)}
            assert got and got == ref["dry"][tag][kind], (kind, got)


@pytest.mark.parametrize("name", jconfigs.ARCH_IDS)
def test_prefill_and_decode_axes_equal_the_reference(name):
    cfg = tconfigs.get_config(name)
    jcfg = jconfigs.get_config(name)
    assert tspecs.prefill_axes(cfg) == jspecs.prefill_axes(jcfg)
    assert tspecs.decode_axes(cfg) == jspecs.decode_axes(jcfg)


def test_traffic_is_counted_only_inside_a_record():
    """A collective adds its bytes and its call to every open
    ``record_traffic`` block (nested ones too) and to nothing outside
    one, so a long run keeps no record of its own."""
    t = torch.zeros(3, 4)
    layout._count("all_gather", "model", t, 1)
    with layout.record_traffic() as outer:
        layout._count("all_gather", "model", t, 1)
        with layout.record_traffic() as inner:
            layout._count("all_reduce", "data", t, 1.5)
        layout._count("reduce_scatter", "model", t, 0.5)
    layout._count("all_gather", "model", t, 1)
    assert inner.bytes == {"data": 72.0}
    assert inner.calls == [("all_reduce", "data", (3, 4))]
    assert outer.bytes == {"model": 72.0, "data": 72.0}
    assert [c[0] for c in outer.calls] == ["all_gather", "all_reduce",
                                           "reduce_scatter"]
    assert not layout._OPEN

"""The port's tensor-parallel compute over the model axis for the ssm and
hybrid families (``RWKV6LM`` / ``Zamba2LM`` built with a ``ShardCtx`` on
a mesh, ``mamba_forward(ctx=)``; ``train.step.ShardedStep``), in one
gloo world of 4 on the CPU, held to the port's one device and to the
reference.

A module fixture writes the numpy inputs and spawns the world
(``launch.mesh.spawn``, file rendezvous; the rank program is
``tests/_torch_tp_ssm_ranks.py``), which builds the (2, 2) and (1, 4)
meshes; meanwhile this process runs the reference on the same inputs:
the forward and the prefill of each case in f32, and one layer's
``mamba_forward`` on one device.

Cases: the reference's smoke configs of rwkv6-7b and zamba2-7b, and
zamba2 with 2 shared-attention heads (``-h2``: on (1, 4) its prefill
attention runs context parallel and its ring cache is split by
head_dim, so a decode step takes the head_dim leg with the ring's
mask).  The ring holds 28 slots, so the 8 decode steps after a prompt
of 24 wrap it.

Weights: the reference's init (``jax.random.key(0)``), its constant
leaves drawn (``test_torch_train_step._draw_constants``), and zamba2's
shared ``wq`` / ``wk`` scaled by 1/16 (``tests/test_torch_tensor_parallel
.py``'s reason: at the reference's init the softmax is nearly one-hot
and carries a flipped bf16 rounding of q or k far).  rwkv6 has no
softmax and is not scaled.

Bounds: ``tests/test_torch_tensor_parallel.py``'s.  Against the port's
one device the median of |got - want| / max |want| within 1e-6 and the
relative Frobenius norm within 1e-4; against the reference
``tests/test_torch_models.py``'s f32 bounds; greedy tokens equal one
device's; the train step at ``tests/test_torch_zero.py``'s bounds.

What is held to one device at those bounds.  Every case: each layer of
the prefill and of every decode step teacher-forced (``walk``: the layer
takes the one-device model's input to it, and the steps its tokens), the
logits of those walks, and every leaf of each layer's state after the
last step (integer leaves equal).  rwkv6 (no softmax): also the forward,
the prefill and the decode steps end to end.  zamba2 end to end is held
to the reference and to one device's greedy tokens only: its shared
block rounds q, k, v and the probabilities to bf16 (as the reference
does), and at this size the one-ulp differences of TP's sum order flip
such a rounding in about half the rows; with the near-uniform attention
of the scaled weights that flip reaches every later position of the row,
so the median of the prefill's one position moves past 1e-6 in the
rows it reaches: such a bound tests rounding luck, not the port.  With
those roundings taken out on both sides (``unrounded``) zamba2's forward
and prefill end to end are held to one device at the bounds.  Teacher
forced, a layer's input is the same bits on one device and on the mesh,
so its roundings are the same.
"""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.models.base import NULL_CTX as JNULL_CTX
from repro.models.mamba2 import mamba_forward as jmamba_forward
from repro_torch.launch.mesh import spawn
from repro_torch.models import ShardCtx, build
from repro_torch.models.base import leaves
from repro_torch.models.mamba2 import mamba_dims
from repro_torch.sharding.rules import merged_rules, opt_rules, param_rules

import _torch_tp_ssm_ranks as ranks
from test_torch_models import F32_BOUNDS, _close
from test_torch_tensor_parallel import (FROB, LOSS_RTOL, SOFTEN, TP_FROB,
                                        TP_MEDIAN, V_FROB, FakeMesh,
                                        _one_device_close)
from test_torch_train_step import _draw_constants, _np, _rel_frob

WORLD = 4
CASES = [(c, s) for c in ranks.CASES for s in ranks.MESHES]
IDS = [f"{c}-{ranks.mesh_tag(s)}" for c, s in CASES]


def _jconfig(case):
    import dataclasses
    arch, changes = ranks.CASES[case]
    return dataclasses.replace(jconfigs.get_config(arch).smoke(),
                               dtype="float32", **changes)


def _soften(tree):
    """zamba2's shared-attention ``wq`` / ``wk`` scaled by SOFTEN."""
    if "shared_attn" in tree:
        tree = dict(tree, shared_attn=dict(tree["shared_attn"]))
        for k in ("wq", "wk"):
            w = tree["shared_attn"][k]
            tree["shared_attn"][k] = (w * SOFTEN).astype(w.dtype)
    return tree


def _reference(case, tree, batch, out):
    model = jbuild(_jconfig(case))
    params = jax.tree.map(jnp.asarray, tree)
    tokens, positions = (jnp.asarray(batch[k]) for k in ("tokens",
                                                          "positions"))
    logits, _ = jax.jit(model.forward)(params, tokens, positions)
    out[f"{case}/logits"] = np.asarray(logits)
    logits, _ = jax.jit(model.prefill, static_argnums=3)(
        params, tokens, positions, ranks.MAX_LEN)
    out[f"{case}/prefill"] = np.asarray(logits)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the world (in a thread) while this process runs the
    reference; -> (reference results, [each rank's results])."""
    tmp = tmp_path_factory.mktemp("tp_ssm")
    rng = np.random.default_rng(0)
    arrays, trees, batches = {}, {}, {}
    for case in ranks.CASES:
        cfg = _jconfig(case)
        trees[case] = _soften(_draw_constants(_np(jbuild(cfg).init(
            jax.random.key(0)))))
        for path, a in leaves(trees[case]):
            arrays[f"{case}/tree/{ranks.key(path)}"] = a
        tokens = rng.integers(0, cfg.vocab, (ranks.B, ranks.S))
        batches[case] = {"tokens": tokens.astype(np.int32),
                         "positions": np.ascontiguousarray(np.broadcast_to(
                             np.arange(ranks.S, dtype=np.int32),
                             (ranks.B, ranks.S)))}
        for k, v in batches[case].items():
            arrays[f"{case}/batch/{k}"] = v
        arrays[f"{case}/train/tokens"] = rng.integers(
            0, cfg.vocab, (1, ranks.B, ranks.S)).astype(np.int32)
    d = _jconfig("zamba2-7b").d_model
    for n, s in (("x", ranks.S), ("x1", 1)):
        arrays[f"mamba/{n}"] = rng.standard_normal(
            (ranks.B, s, d)).astype(np.float32)
    np.savez(tmp / "inputs.npz", **arrays)
    dry = ranks.start_dry(tmp, "_torch_tp_ssm_ranks")

    failed = []

    def run():
        try:
            spawn(ranks.tp_ssm_main, WORLD, str(tmp),
                  init_method=f"file://{tmp}/store")
        except BaseException as e:     # re-raised on the test's thread
            failed.append(e)
    thread = threading.Thread(target=run)
    thread.start()
    ref = {}
    try:
        for case in ranks.CASES:
            _reference(case, trees[case], batches[case], ref)
        cfg = _jconfig("zamba2-7b")
        p = jax.tree.map(lambda a: jnp.asarray(a[ranks.MAMBA_LAYER]),
                         trees["zamba2-7b"]["layers"]["mamba"])
        y, _ = jmamba_forward(p, jnp.asarray(arrays["mamba/x"]), cfg,
                              JNULL_CTX)
        ref["mamba"] = np.asarray(y)
    finally:
        thread.join()
        dry.wait(timeout=600)
    if failed:
        raise failed[0]
    assert dry.returncode == 0, "the dry run failed"
    ref["dry"] = json.loads((tmp / "dry.json").read_text())
    return ref, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def _tag(case, shape):
    return f"{case}/{ranks.mesh_tag(shape)}"


def _softmax(case) -> bool:
    """Whether the case has a softmax (zamba2's shared block), whose bf16
    roundings make an end-to-end comparison with one device a test of
    rounding luck (module docstring)."""
    return ranks.config(case).hybrid_attn_every > 0


def _ctx(shape):
    mesh = FakeMesh(data=shape[0], model=shape[1])
    return ShardCtx(mesh, merged_rules(mesh))


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_forward_matches_one_device_and_reference(world, case, shape):
    ref, outs = world
    got = outs[0][f"{_tag(case, shape)}/logits"]
    _close(f"{case} TP logits vs reference", got, ref[f"{case}/logits"],
           F32_BOUNDS)
    if not _softmax(case):
        _one_device_close(f"{case} logits", got,
                          outs[0][f"one/{case}/logits"])


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_prefill_and_greedy_decode_match_one_device(world, case, shape):
    """The prefill's logits at the f32 bounds to the reference's; the 8
    greedy decode steps feed the same tokens as one device's; without a
    softmax (rwkv6) the prefill's and the steps' logits are held to one
    device's."""
    ref, outs = world
    out, tag = outs[0], _tag(case, shape)
    got = out[f"{tag}/prefill"]
    _close(f"{case} TP prefill vs reference", got, ref[f"{case}/prefill"],
           F32_BOUNDS)
    np.testing.assert_array_equal(out[f"{tag}/fed"], out[f"one/{case}/fed"])
    assert out[f"{tag}/fed"].shape == (ranks.B, ranks.DECODE)
    if not _softmax(case):
        _one_device_close(f"{case} prefill", got,
                          out[f"one/{case}/prefill"])
        _one_device_close(f"{case} decode", out[f"{tag}/decode"],
                          out[f"one/{case}/decode"])


@pytest.mark.parametrize("case,shape", [c for c in CASES if _softmax(c[0])],
                         ids=[i for c, i in zip(CASES, IDS) if _softmax(c[0])])
def test_end_to_end_without_the_bf16_roundings_matches_one_device(
        world, case, shape):
    """zamba2's forward and prefill end to end with the attention's bf16
    roundings of q / k / v / p taken out on both sides (``unrounded``):
    TP's sum order alone then stays within the one-device bounds, so
    what moves the rounded end to end further is those roundings
    (module docstring)."""
    _, outs = world
    out, tag = outs[0], _tag(case, shape)
    for k in ("unrounded", "unrounded_pre"):
        _one_device_close(f"{case} {k}", out[f"{tag}/{k}"],
                          out[f"one/{case}/{k}"])


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_layers_teacher_forced_match_one_device(world, case, shape):
    """Each layer's output in the prefill and in each of the 8 decode
    steps, every layer taking the one-device model's input to it, and the
    logits of that walk, held to one device's."""
    _, outs = world
    out, tag, one = outs[0], _tag(case, shape), f"one/{case}/walk"
    cfg = ranks.config(case)
    n = cfg.n_layers + (cfg.n_layers // cfg.hybrid_attn_every
                        if cfg.hybrid_attn_every else 0)
    got, want = out[f"{tag}/walk/outs"], out[f"{one}/outs"]
    assert got.shape == want.shape == (n, ranks.B, ranks.S, cfg.d_model)
    for i in range(n):
        _one_device_close(f"{case} prefill layer {i}", got[i], want[i])
    got, want = out[f"{tag}/walk/dec_outs"], out[f"{one}/dec_outs"]
    assert got.shape == want.shape == (ranks.DECODE, n, ranks.B, 1,
                                       cfg.d_model)
    for t in range(ranks.DECODE):
        for i in range(n):
            _one_device_close(f"{case} step {t} layer {i}", got[t, i],
                              want[t, i])
    _one_device_close(f"{case} teacher-forced logits",
                      out[f"{tag}/walk/logits"], out[f"{one}/logits"])


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_cache_blocks_follow_cache_axes(world, case, shape):
    """After the prefill and after each decode step every cache leaf a
    rank holds is its block under ``cache_axes`` (its rows and its
    model-axis slice: rwkv6's ``s`` and mamba's ``s`` by heads, mamba's
    ``conv`` by its conv block's channels, the ring's ``k`` / ``v`` by
    heads or head_dim); each layer's state after the teacher-forced walk's
    last step, gathered whole, is one device's (float leaves at the
    one-device bounds, integer leaves equal)."""
    _, outs = world
    cfg, tag, ctx = ranks.config(case), _tag(case, shape), _ctx(shape)
    model = build(cfg, device="meta")
    full = dict(leaves(model.init_cache(ranks.B, ranks.MAX_LEN)))
    axes = dict(leaves(model.cache_axes()))
    split = 0
    for out in outs:
        for when in ["prefill"] + [f"step{t}" for t in range(ranks.DECODE)]:
            prefix = f"{tag}/cache/{when}/"
            got = {k[len(prefix):]: tuple(v) for k, v in out.items()
                   if k.startswith(prefix)}
            assert set(got) == {ranks.key(p) for p in full}, when
            for path, t in full.items():
                want = ctx.sharding(t.shape, axes[path]).shard_shape(t.shape)
                assert got[ranks.key(path)] == want, (when, path, want)
                split += want[2:] != tuple(t.shape)[2:]
    assert split > 0
    prefix = f"{tag}/walk/state/"
    states = [k[len(prefix):] for k in outs[0] if k.startswith(prefix)]
    assert states
    for k in states:
        got, want = outs[0][prefix + k], outs[0][f"one/{case}/walk/state/{k}"]
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            _one_device_close(f"{case} state {k}", got, want)


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_train_step_matches_one_device(world, case, shape):
    """The ZeRO + TP step: loss within 1e-5, each gathered gradient within
    1e-2 in relative Frobenius norm, no parameter more than 2 lr (+ 1e-6)
    from one device's step, m within 1e-2 and v within 2e-2 (the bounds
    of ``tests/test_torch_zero.py``).  A gradient off by a factor of the
    model axis (a replicated leaf's partial sums not summed, or summed
    twice) misses the Frobenius bound by far."""
    _, outs = world
    out, tag, one = outs[0], _tag(case, shape), f"one/{case}"
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


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_replicated_shards_are_bitwise_equal(world, case, shape):
    """After the step, ranks that hold the same block of a leaf hold the
    same bits, and every rank reports the same loss."""
    _, outs = world
    tag, i = _tag(case, shape), ranks.MESHES.index(shape)
    assert len({float(o[f"{tag}/loss"]) for o in outs}) == 1
    cfg = ranks.config(case)
    mesh = FakeMesh(data=shape[0], model=shape[1])
    decls = build(cfg, device="meta").decls()
    p = ShardCtx(mesh, param_rules(mesh, zero3=cfg.zero3)).param_shardings(
        decls)
    o = ShardCtx(mesh, opt_rules(mesh)).param_shardings(decls)
    pairs = 0
    for part, tree in (("params", p), ("m", o), ("v", o)):
        for path, s in leaves(tree):
            k, held = ranks.key(path), {}
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
    merged_rules(mesh))``, and some weights are split."""
    _, outs = world
    cfg, ctx = ranks.config(case), _ctx(shape)
    for out in outs:
        bad = out[f"{_tag(case, shape)}/bad_weights"]
        assert bad.size == 0, bad
    decls = build(cfg, device="meta").decls()
    assert any(ctx.sharding(p.shape, p.axes).shard_shape(p.shape)
               != p.shape for _, p in leaves(decls))


def _param_shapes(case, shape, split_only=False) -> set:
    """Each weight's shape, whole and as a rank's block (a stacked leaf's
    per-layer shapes); with ``split_only`` those of the weights the rules
    split over the model axis, less the shapes of the weights they do not
    split (whose gradients, partial sums over the axis, a train step
    all-reduces over it: zamba2's 128-wide ``ln_in`` beside the mamba
    ``norm`` of d_inner 128)."""
    cfg, ctx = ranks.config(case), _ctx(shape)
    split, whole = set(), set()
    for path, p in leaves(build(cfg, device="meta").decls()):
        block = ctx.sharding(p.shape, p.axes).shard_shape(p.shape)
        for s in (p.shape, block):
            (whole if block == tuple(p.shape) else split).add(
                ",".join(map(str, s[1:] if path[0] == "layers" else s)))
    return split - whole if split_only else split | whole


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_no_weight_crosses_the_model_axis(world, case, shape):
    """``layout.record_traffic`` over a forward and over a prefill with
    its decode steps: collectives over the model axis carry activations
    only, never a tensor of a weight's shape (whole or a block).  In the
    train step only the gradients of the weights the model axis does not
    split cross it (their partial sums, all-reduced)."""
    _, outs = world
    tag = _tag(case, shape)
    weights = _param_shapes(case, shape)
    split = _param_shapes(case, shape, split_only=True)
    for out in outs:
        for rec, shapes in (("fwd_records", weights),
                            ("decode_records", weights),
                            ("train_records", split)):
            recs = [tuple(r) for r in out[f"{tag}/{rec}"]]
            model = [r for r in recs if r[1] == "model"]
            assert model, rec
            assert not [r for r in model if r[2] in shapes], rec


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_each_case_takes_the_references_legs(world, case, shape):
    """zamba2's mamba layers all-gather their ``in_proj`` output and
    their conv output over the model axis and all-reduce the gated
    norm's sum of squares, once a layer; the shared block runs context
    parallel where its heads do not divide the model axis (once an
    invocation), and a decode step then takes the head_dim leg: one
    all-reduce of the (B, H, 1, W) ring logits an invocation and step.
    rwkv6 takes neither leg."""
    _, outs = world
    cfg, tag, m = ranks.config(case), _tag(case, shape), shape[1]
    out = outs[0]
    fwd = [tuple(r) for r in out[f"{tag}/fwd_records"]]
    dec = [tuple(r) for r in out[f"{tag}/decode_records"]]
    B_loc, S = ranks.B // shape[0], ranks.S
    if cfg.hybrid_attn_every == 0:
        assert int(out[f"{tag}/cp"]) == 0
        assert not [r for r in dec if r[0] == "all_reduce" and
                    r[2].count(",") == 3]
        return
    dims, G = mamba_dims(cfg), cfg.n_layers // cfg.hybrid_attn_every
    for width in (dims["d_in_proj"], dims["conv_ch"]):
        assert width % m == 0
        rec = ("all_gather", "model", f"{B_loc},{S},{width // m}")
        assert fwd.count(rec) == cfg.n_layers, rec
    assert fwd.count(("all_reduce", "model",
                      f"{B_loc},{S},1")) == cfg.n_layers
    cp = cfg.n_heads % m != 0
    assert int(out[f"{tag}/cp"]) == (G if cp else 0)
    logits = ("all_reduce", "model",
              f"{B_loc},{cfg.n_heads},1,{ranks.MAX_LEN}")
    assert dec.count(logits) == (G * ranks.DECODE if cp else 0)


def test_mamba_forward_on_blocks_that_straddle_z_and_x(world):
    """One zamba2 smoke layer's ``mamba_forward(ctx=)`` on (1, 4): the
    328-wide ``in_proj`` is 82 columns a rank, so rank 1's block
    (82..163) holds the end of ``z`` and the start of ``x``.  Its prefill
    output (the layer boundary's layout, gathered) and a decode step
    from its state are held to one device, and the prefill to the
    reference at the f32 bounds; each rank's state is its block of one
    device's (``conv`` by channels, ``s`` by heads)."""
    ref, outs = world
    di = mamba_dims(ranks.config("zamba2-7b"))["d_inner"]
    lo, hi = outs[1]["mamba/in_proj_cols"]
    assert lo < di < hi
    for out in outs:
        _one_device_close("mamba prefill", out["mamba/got"],
                          out["mamba/one"])
        _one_device_close("mamba decode", out["mamba/got_dec"],
                          out["mamba/one_dec"])
        _close("mamba prefill vs reference", out["mamba/got"], ref["mamba"],
               F32_BOUNDS)
        for k in ("conv", "s"):
            got, want = out[f"mamba/state/{k}"], out[f"mamba/one_state/{k}"]
            assert got.shape == want.shape, k
            _one_device_close(f"mamba state {k}", got, want)
        assert {"all_gather", "all_reduce", "reduce_scatter"} >= {
            r[0] for r in out["mamba/records"]}


@pytest.mark.parametrize("case,shape", CASES, ids=IDS)
def test_dry_run_bytes_equal_the_worlds(world, case, shape):
    """The dry run of the case on its mesh (``launch.dryrun.measure`` in a
    fake world of that shape, rank 0, on ``meta``): the bytes its
    prefill, one decode step and the train step send over each mesh axis
    equal, exactly, what every rank of this gloo world counted."""
    ref, outs = world
    tag = _tag(case, shape)
    for kind in ("prefill", "decode", "train"):
        prefix = f"{tag}/bytes/{kind}/"
        for out in outs:
            got = {k[len(prefix):]: float(v) for k, v in out.items()
                   if k.startswith(prefix)}
            assert got and got == ref["dry"][tag][kind], (kind, got)

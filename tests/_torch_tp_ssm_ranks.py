"""The rank program of ``tests/test_torch_tp_ssm.py``.

``tp_ssm_main(rank, tmp)`` runs on every rank of a ``gloo`` world of 4
that ``repro_torch.launch.mesh.spawn`` starts on the CPU.  It reads the
numpy inputs (``inputs.npz``: each case's parameter tree, prompt and
train batch, and ``mamba_forward``'s operands) from ``tmp``, builds the
(2, 2) and (1, 4) debug meshes in that one world, and runs:

* the port's one-device model of each case (forward, prefill and greedy
  decode with the cache after the last step, the gradient and one AdamW
  step) in this process;
* on each mesh, the tensor-parallel model of the case on this rank's
  rows (``launch.specs.prefill_axes`` / ``decode_axes``): forward,
  prefill and the same greedy decode (each cache leaf's local shape after
  the prefill and after every step, the last cache gathered whole), and
  the ZeRO + TP train step;
* one layer's ``mamba_forward(ctx=)`` on (1, 4), a prefill and a decode
  step from its state, against one device.

For zamba2 it also runs the forward and the prefill with the attention's
bf16 roundings taken out (``unrounded``), on one device and on each mesh.
It counts the context-parallel leg (``_attn_context_parallel``) and
records every collective (``sharding.layout.record_traffic``).  Each rank
writes what it computed to ``rank<rank>.npz``: its local blocks, and on
rank 0 the gathered tensors and the one-device results.  The shared
pieces are ``tests/_torch_tp_ranks.py``'s.  This module imports neither
JAX nor the reference package, so a rank starts with the port alone.
"""
import contextlib
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.specs import prefill_axes
from repro_torch.models import ShardCtx, attention, build
from repro_torch.models.base import leaves, tree_map
from repro_torch.models.mamba2 import mamba_forward
from repro_torch.sharding import layout
from repro_torch.sharding.rules import merged_rules
from repro_torch.train import (AdamWConfig, apply_updates, init_state,
                               make_train_step, shard_state, zero_shardings)
from repro_torch.train.step import backward_into

import _torch_tp_ranks
from _torch_tp_ranks import (Legs, _put, _tensors, _tree, _weight_ok,
                             greedy, key, mesh_tag, put_bytes, serve_bytes,
                             start_dry, step_blocks)

# case -> (architecture, changes to its smoke config)
CASES = {
    "rwkv6-7b": ("rwkv6-7b", {}),
    "zamba2-7b": ("zamba2-7b", {}),
    # 2 shared-attention heads on a model axis of 4: context-parallel
    # prefill and the head_dim ring decode
    "zamba2-7b-h2": ("zamba2-7b", {"n_heads": 2}),
}
MESHES = ((2, 2), (1, 4))
# S makes every activation that crosses the model axis a shape that no
# weight has; MAX_LEN < S + DECODE wraps zamba2's ring (W = MAX_LEN).
B, S, MAX_LEN, DECODE = 4, 24, 28, 8
OPT = dict(lr=1e-3, warmup_steps=1)
# mamba_forward on (1, 4): the zamba2 smoke layer's in_proj is 328 wide,
# 82 columns a rank, so rank 1's block (82..163) straddles z | x (128).
MAMBA_MESH, MAMBA_LAYER = (1, 4), 1


def config(case: str):
    arch, changes = CASES[case]
    return dataclasses.replace(get_config(arch).smoke(), dtype="float32",
                               **changes)


def _records(calls) -> np.ndarray:
    return np.array([[op, axis, ",".join(map(str, s))]
                     for op, axis, s in calls], dtype=str).reshape(-1, 3)


@contextlib.contextmanager
def unrounded():
    """Attention without its bf16 roundings of q, k, v and the
    probabilities (the operands widened to f32 as they are), on one
    device and on the mesh alike."""
    saved = attention._bf16_f32
    attention._bf16_f32 = lambda x: x.float()
    try:
        yield
    finally:
        attention._bf16_f32 = saved


def _unrounded(model, batch: dict, lay, whole) -> tuple:
    """(forward logits, prefill logits) of ``unrounded`` attention."""
    pa = prefill_axes(model.cfg)
    args = [lay(batch[k], pa[k]) for k in ("tokens", "positions")]
    with torch.no_grad(), unrounded():
        logits, _ = model.forward(*args)
        first, _ = model.prefill(*args, MAX_LEN)
    return whole(logits).numpy(), whole(first).numpy()


def _numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` as numpy, a bf16 cache leaf widened to f32 (exactly)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def layers(model) -> list:
    """The model's layers in the order its prefill runs them, each as
    ``fn(x, x0, positions, S, state) -> (x, new state)``: ``state`` None
    is the prefill (zamba2's ring of MAX_LEN slots), else one decode step
    against that layer's state (a shared-block ring is written in
    place)."""
    if model.cfg.hybrid_attn_every == 0:
        return [lambda x, x0, pos, S, st, p=p: model._block(p, x, st, S)
                for p in model.params["layers"]]
    out = []
    for group, g in model.groups():
        out += [lambda x, x0, pos, S, st, i=i: model._mamba(i, x, S, st)
                for i in group]
        if g is not None:
            out.append(lambda x, x0, pos, S, st: model._shared_attn(
                x, x0, pos, cache=st,
                fill_window=MAX_LEN if st is None else None))
    return out


def walk(model, batch: dict, fed=None, forced=None, lay=None) -> dict:
    """The prefill and DECODE decode steps layer by layer, as ``prefill``
    / ``decode_step`` run them: each layer's input and output (whole:
    every row and position), the logits (whole over the vocab and the
    rows) and the state after the last step.  The steps feed ``fed`` (B,
    DECODE), else the greedy tokens; with ``forced`` (another walk's
    record) every layer takes that walk's input to it (teacher forcing).
    ``lay`` takes this rank's block of a whole input by logical axes."""
    ctx = model.ctx
    lay = lay or (lambda t, axes: t)
    tokens, positions = batch["tokens"], batch["positions"]
    S = tokens.shape[1]
    rows = lambda t: ctx.gather_rows(t, B)
    whole = lambda t: rows(model.gather_vocab(t))
    rec = dict(ins=[], outs=[], dec_ins=[], dec_outs=[], logits=[], fed=[])
    fns, states = layers(model), []
    with torch.no_grad():
        pos = lay(positions, ("batch", None))
        x = x0 = model.embed(lay(tokens, ("batch", None)))
        for i, fn in enumerate(fns):
            if forced is not None:
                x = lay(forced["ins"][i], ("batch", "seq", None))
            rec["ins"].append(rows(ctx.gather_seq(x, S)))
            x, st = fn(x, x0, pos, S, None)
            rec["outs"].append(rows(ctx.gather_seq(x, S)))
            if "x_tm" in st:           # prefill hands these on in bf16
                st = {k: v.to(torch.bfloat16) if k != "s" else v
                      for k, v in st.items()}
            states.append(st)
        rec["logits"].append(whole(model.logits(model.last_position(x,
                                                                     S))))
        nxt = rec["logits"][0].argmax(-1)
        for t in range(DECODE):
            tok = fed[:, t:t + 1] if fed is not None else nxt
            rec["fed"].append(tok)
            p_t = lay(positions[:, -1:] + 1 + t, ("batch", None))
            x = x0 = model.embed(lay(tok, ("batch", None)))
            di, do = [], []
            for i, fn in enumerate(fns):
                if forced is not None:
                    x = lay(forced["dec_ins"][t][i], ("batch", None, None))
                di.append(rows(x))
                x, states[i] = fn(x, x0, p_t, 1, states[i])
                do.append(rows(x))
            rec["dec_ins"].append(di)
            rec["dec_outs"].append(do)
            rec["logits"].append(whole(model.logits(x)))
            nxt = rec["logits"][-1].argmax(-1)
    rec["fed"] = torch.cat(rec["fed"], 1)
    rec["logits"] = torch.cat(rec["logits"], 1)
    rec["states"] = states
    return rec


def _walk_out(out: dict, prefix: str, rec: dict) -> None:
    """A walk's layer outputs and logits (rank 0's copy)."""
    out[f"{prefix}/outs"] = torch.stack(rec["outs"]).numpy()
    out[f"{prefix}/dec_outs"] = torch.stack(
        [torch.stack(d) for d in rec["dec_outs"]]).numpy()
    out[f"{prefix}/logits"] = rec["logits"].numpy()


def state_axes(model) -> list[dict]:
    """The logical axes of each layer's state in ``walk``'s order (one
    layer's ``cache_axes``)."""
    ax = {k: {n: a[1:] for n, a in v.items()}
          for k, v in model.cache_axes().items() if k != "x0"}
    if model.cfg.hybrid_attn_every == 0:
        return [ax["layers"]] * model.cfg.n_layers
    out = []
    for group, g in model.groups():
        out += [ax["mamba"]] * len(group)
        if g is not None:
            out.append(ax["attn"])
    return out


def _one_device(case, cfg, tree, z, out, rec) -> None:
    """The port's one-device forward, prefill + greedy decode, layer
    walk (``rec``), gradient and one step."""
    model = build(cfg, device="cpu").load_tree(tree)
    batch = _tensors(z, f"{case}/batch")
    with torch.no_grad():
        logits, _ = model.forward(batch["tokens"], batch["positions"])
    out[f"one/{case}/logits"] = logits.numpy()
    first, fed, steps, _ = greedy(model, batch, max_len=MAX_LEN,
                                  steps=DECODE)
    out[f"one/{case}/prefill"] = first.numpy()
    out[f"one/{case}/fed"] = fed.numpy()
    out[f"one/{case}/decode"] = steps.numpy()
    if cfg.hybrid_attn_every:
        out[f"one/{case}/unrounded"], out[f"one/{case}/unrounded_pre"] = \
            _unrounded(model, batch, lambda t, axes: t, lambda t: t)
    _walk_out(out, f"one/{case}/walk", rec)
    for i, st in enumerate(rec["states"]):
        for k, v in st.items():
            out[f"one/{case}/walk/state/{i}/{k}"] = _numpy(v)
    train = _tensors(z, f"{case}/train")
    masters = tree_map(lambda t: t.clone().requires_grad_(), tree)
    loss = backward_into(build(cfg, device="meta"), masters,
                         {"tokens": train["tokens"][0]})
    out[f"one/{case}/loss"] = float(loss)
    grads = tree_map(lambda m: m.grad, masters)
    _put(out, f"one/{case}/grads", grads)
    opt = AdamWConfig(**OPT)
    state, _ = apply_updates(init_state(tree_map(torch.clone, tree), opt),
                             grads, opt)
    for part in ("params", "m", "v"):
        _put(out, f"one/{case}/{part}", getattr(state, part))


def _mesh_case(rank, case, cfg, tree, z, mesh, tag, out, one) -> None:
    """The TP model of a case on ``mesh``; ``one`` is the one-device
    model's walk, which the TP walk is teacher-forced by."""
    ctx = ShardCtx(mesh, merged_rules(mesh))
    model = build(cfg, ctx, device="cpu").load_tree(tree)
    out[f"{tag}/bad_weights"] = np.array(_weight_ok(ctx, model), dtype=str)
    batch = _tensors(z, f"{case}/batch")
    pa = prefill_axes(cfg)
    lay = lambda t, axes: ctx.local(t, *axes)
    whole = lambda t: ctx.gather_rows(model.gather_vocab(t), B)
    with torch.no_grad(), Legs() as legs, layout.record_traffic() as fwd:
        logits, _ = model.forward(*(lay(batch[k], pa[k])
                                    for k in ("tokens", "positions")))
    out[f"{tag}/fwd_records"] = _records(fwd.calls)
    out[f"{tag}/cp"] = legs.n["cp"]
    logits = whole(logits)
    caches = []
    with layout.record_traffic() as dec:
        first, fed, steps, shapes = greedy(model, batch, lay, whole,
                                           max_len=MAX_LEN, steps=DECODE,
                                           caches=caches)
    out[f"{tag}/decode_records"] = _records(dec.calls)
    for k, s in shapes.items():
        out[f"{tag}/cache/prefill/{key(k)}"] = np.array(s)
    for t, c in enumerate(caches):
        for k, v in leaves(c):
            out[f"{tag}/cache/step{t}/{key(k)}"] = np.array(v.shape)
    serve_bytes(out, tag, model, batch, lay, MAX_LEN)
    if cfg.hybrid_attn_every:
        got = _unrounded(model, batch, lay, whole)
        if rank == 0:
            out[f"{tag}/unrounded"], out[f"{tag}/unrounded_pre"] = got
    rec = walk(model, batch, fed=one["fed"], forced=one, lay=lay)
    for i, (st, axes) in enumerate(zip(rec["states"], state_axes(model))):
        for k, v in st.items():
            full = one["states"][i][k].shape
            if tuple(v.shape) != ctx.sharding(full, axes[k]).shard_shape(
                    full):
                raise AssertionError(f"state {i} {k}: {tuple(v.shape)}")
            v = layout.gather(v, ctx.sharding(full, axes[k]))
            if rank == 0:
                out[f"{tag}/walk/state/{i}/{k}"] = _numpy(v)
    if rank == 0:
        _walk_out(out, f"{tag}/walk", rec)
        out[f"{tag}/logits"] = logits.numpy()
        out[f"{tag}/prefill"] = first.numpy()
        out[f"{tag}/fed"] = fed.numpy()
        out[f"{tag}/decode"] = steps.numpy()

    # the ZeRO + TP train step: gradients, then one step
    psh, gsh = zero_shardings(model, mesh)
    opt = AdamWConfig(**OPT)
    state = shard_state(tree, opt, psh, gsh)
    step = make_train_step(build(cfg, ctx, device="meta"), opt, gsh,
                           param_shardings=psh, device="cpu")
    out[f"{tag}/blocks"] = step_blocks(step, state, model)
    train = {k: v.numpy() for k, v in _tensors(z, f"{case}/train").items()}
    with layout.record_traffic() as trained:
        loss, grads = step.grads(state, train)
    out[f"{tag}/train_records"] = _records(trained.calls)
    out[f"{tag}/grads_loss"] = float(loss)
    full = [layout.gather(g, s) for (_, g), (_, s) in zip(leaves(grads),
                                                          leaves(gsh))]
    if rank == 0:
        for (path, _), g in zip(leaves(grads), full):
            out[f"{tag}/grads/{key(path)}"] = g.numpy()
    with layout.record_traffic() as trained_step:
        state, metrics = step(state, train, 0)
    put_bytes(out, f"{tag}/bytes/train", trained_step)
    out[f"{tag}/loss"] = float(metrics["loss"])
    for part, sh in (("params", psh), ("m", gsh), ("v", gsh)):
        tree_ = getattr(state, part)
        _put(out, f"{tag}/local/{part}", tree_)
        full = [layout.gather(t, s) for (_, t), (_, s) in zip(
            leaves(tree_), leaves(sh))]
        if rank == 0:
            for (path, _), t in zip(leaves(tree_), full):
                out[f"{tag}/{part}/{key(path)}"] = t.numpy()


def _mamba(z, mesh, out) -> None:
    """One zamba2 smoke layer's ``mamba_forward`` on ``mesh`` and on one
    device: a prefill of the (B, S, d) input (whole over the sequence, as
    the model passes it), then one decode step from its state."""
    cfg = config("zamba2-7b")
    tree = _tree(z, "zamba2-7b", cfg)
    ctx = ShardCtx(mesh, merged_rules(mesh))
    one = build(cfg, device="cpu").load_tree(tree)
    tp = build(cfg, ctx, device="cpu").load_tree(tree)
    x, x1 = (torch.from_numpy(z[f"mamba/{n}"]) for n in ("x", "x1"))
    p1 = one.params["layers"][MAMBA_LAYER]["mamba"]
    pm = tp.params["layers"][MAMBA_LAYER]["mamba"]
    axes = {k: v[1:] for k, v in tp.cache_axes()["mamba"].items()}
    with torch.no_grad():
        y1, st1 = mamba_forward(p1, x, cfg)
        d1, _ = mamba_forward(p1, x1, cfg, state=st1)
        with layout.record_traffic() as rec:
            y, st = mamba_forward(pm, x, cfg, ctx=ctx)
            d, st_next = mamba_forward(pm, x1, cfg, ctx=ctx, state=st)
        y = ctx.gather_seq(y, S)
    out["mamba/one"], out["mamba/one_dec"] = y1.numpy(), d1.numpy()
    out["mamba/got"], out["mamba/got_dec"] = y.numpy(), d.numpy()
    out["mamba/records"] = _records(rec.calls)
    for k, v in st.items():
        out[f"mamba/state/{k}"] = v.numpy()
        out[f"mamba/one_state/{k}"] = ctx.local(st1[k], *axes[k]).numpy()
    out["mamba/in_proj_cols"] = np.array(
        [ctx.model_rank * pm["in_proj"].shape[1],
         (ctx.model_rank + 1) * pm["in_proj"].shape[1]])
    out["mamba/state_next"] = np.array(sorted(st_next))


def tp_ssm_main(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)       # four ranks share the host's cores
    z = np.load(os.path.join(tmp, "inputs.npz"))
    out: dict = {}
    meshes = {shape: make_debug_mesh(*shape, device_type="cpu")
              for shape in MESHES}
    for case in CASES:
        cfg = config(case)
        tree = _tree(z, case, cfg)
        one = walk(build(cfg, device="cpu").load_tree(tree),
                   _tensors(z, f"{case}/batch"))
        if rank == 0:
            _one_device(case, cfg, tree, z, out, one)
        for shape, mesh in meshes.items():
            _mesh_case(rank, case, cfg, tree, z, mesh,
                       f"{case}/{mesh_tag(shape)}", out, one)
    _mamba(z, meshes[MAMBA_MESH], out)
    out["coordinate"] = np.array([meshes[s].get_coordinate()
                                  for s in MESHES])
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)


def dry_main(tmp: str) -> None:
    """``_torch_tp_ranks.dry_main`` on this module's cases."""
    _torch_tp_ranks.dry_main(tmp, CASES, config, MESHES, MAX_LEN)

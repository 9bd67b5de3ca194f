"""The rank program of ``tests/test_torch_tensor_parallel.py``.

``tp_main(rank, tmp)`` runs on every rank of a ``gloo`` world of 4 that
``repro_torch.launch.mesh.spawn`` starts on the CPU.  It reads the numpy
inputs (``inputs.npz``: each case's parameter tree, prompt, decode and
train batches, and the attention legs' operands) from ``tmp``, builds the
(2, 2) and (1, 4) debug meshes in that one world, and runs:

* the port's one-device model of each case (forward, loss, prefill and
  greedy decode, the gradient and one AdamW step) in this process;
* on each mesh, the tensor-parallel model of the case on this rank's
  rows (``launch.specs.prefill_axes`` / ``decode_axes``): forward,
  prefill and the same greedy decode, and the ZeRO + TP train step;
* ``chunked_attention`` and ``decode_attention`` at the reference test's
  shapes on (1, 4), where they take their context-parallel and head_dim
  legs.

It counts the legs each case takes (``_attn_context_parallel``,
``_routed_ep`` and ``_routed`` with a split expert hidden dim) and
records each forward's collectives (``sharding.layout.record_traffic``),
and the bytes a prefill, one decode step and the train step send over
each mesh axis (``serve_bytes``).  Each rank writes what it computed to
``rank<rank>.npz``: its local blocks, and on rank 0 the gathered tensors
and the one-device results.

``dry_main(tmp)`` runs the dry run (``launch.dryrun.measure``, in a fake
world of each mesh's shape) of the same steps on the inputs' shapes and
writes their bytes by axis to ``dry.json``: run it in a process of its
own (the fake process group is process-global).  This module imports
neither JAX nor the reference package, so a rank starts with the port
alone.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.config import ShapeSpec
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.specs import decode_axes, prefill_axes
from repro_torch.models import ShardCtx, attention, build, ffn
from repro_torch.models.base import leaves, tree_map
from repro_torch.sharding import layout
from repro_torch.sharding.rules import merged_rules
from repro_torch.train import (AdamWConfig, apply_updates, init_state,
                               make_train_step, shard_state, zero_shardings)
from repro_torch.train.step import backward_into

# case -> (architecture, changes to its smoke config)
CASES = {
    "llama3-8b": ("llama3-8b", {}),
    "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", {}),
    "qwen2-vl-2b": ("qwen2-vl-2b", {}),
    "starcoder2-3b": ("starcoder2-3b", {}),
    # 6 heads on a model axis of 4: context-parallel attention in a model
    "starcoder2-3b-h6": ("starcoder2-3b", {"n_heads": 6}),
    # 6 experts on a model axis of 4: the expert hidden dim takes it
    "deepseek-v2-lite-16b-e6": ("deepseek-v2-lite-16b", {"n_experts": 6}),
}
MESHES = ((2, 2), (1, 4))
# S and S_IMG make every activation that crosses the model axis a shape
# that no weight has ((B / data, S / model, d) is not a wo block).
B, S, S_IMG, MAX_LEN, DECODE = 4, 24, 12, 64, 8
OPT = dict(lr=1e-3, warmup_steps=1)
# The attention legs at tests/test_sharding.py's shapes.
CP_SHAPE, CP_CHUNK, SCALE = (4, 256, 6, 16), 64, 0.25
DEC_SHAPE, DEC_HQ, DEC_LEN = (4, 64, 2, 16), 4, 33


def change(cfg, changes: dict):
    """``cfg`` with ``changes``; ``n_experts`` goes to its MoE config."""
    changes = dict(changes)
    if "n_experts" in changes:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=changes.pop("n_experts"))
    return dataclasses.replace(cfg, **changes)


def config(case: str):
    arch, changes = CASES[case]
    return change(dataclasses.replace(get_config(arch).smoke(),
                                      dtype="float32"), changes)


def key(path) -> str:
    return "/".join(map(str, path))


def mesh_tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def split_rows(case: str, shape) -> int:
    """The data ranks a MoE case's aux loss is taken over (per data
    shard, as ``_routed_ep`` takes it): its one-device gradient is the
    mean over that many row slices."""
    return shape[0] if config(case).moe is not None else 1


def _tensors(z, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: torch.from_numpy(z[k].copy())
            for k in z.files if k.startswith(prefix + "/")}


def _tree(z, case: str, cfg):
    decls = build(cfg, device="meta").decls()
    return tree_map(lambda path, _: torch.from_numpy(
        z[f"{case}/tree/{key(path)}"].copy()), decls, with_path=True)


def _put(out: dict, prefix: str, tree) -> None:
    for path, t in leaves(tree):
        out[f"{prefix}/{key(path)}"] = t.detach().numpy().copy()


class Legs:
    """Counts the calls of the tensor-parallel legs while installed."""

    def __init__(self):
        self.n = {"cp": 0, "ep": 0, "moe_mlp": 0}
        self._saved = []

    def __enter__(self):
        def wrap(mod, name, tag, when=lambda *a: True):
            fn = getattr(mod, name)

            def run(*args, **kw):
                if when(*args):
                    self.n[tag] += 1
                return fn(*args, **kw)
            self._saved.append((mod, name, fn))
            setattr(mod, name, run)
        wrap(attention, "_attn_context_parallel", "cp")
        wrap(ffn, "_routed_ep", "ep")
        wrap(ffn, "_routed", "moe_mlp",
             lambda p, *a: ffn.model_split(p, "w_gate", 2))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def greedy(model, batch: dict, lay=lambda t, axes: t, gather=None,
           max_len: int = MAX_LEN, steps: int = DECODE, caches=None):
    """Prefill, then ``steps`` greedy steps -> (prefill logits, [fed
    tokens], [each step's logits], cache after prefill's shapes); ``lay``
    takes this rank's block of a full input, ``gather`` assembles the
    logits whole (vocab and rows); ``caches``, a list, receives the cache
    after each step (a copy)."""
    cfg = model.cfg
    pa, da = prefill_axes(cfg), decode_axes(cfg)
    gather = gather or (lambda t: t)
    args = [lay(batch["tokens"], pa["tokens"]),
            lay(batch["positions"], pa["positions"]), max_len,
            lay(batch["extra_embeds"], pa["extra_embeds"])
            if "extra_embeds" in batch else None]
    logits, cache = model.prefill(*args)
    shapes = {k: tuple(v.shape) for k, v in leaves(cache)}
    first = gather(logits)
    nxt, last = first.argmax(-1), batch["positions"][..., -1:]
    fed, outs = [], []
    for t in range(steps):
        fed.append(nxt)
        logits, cache = model.decode_step(
            cache, lay(nxt, da["tokens"]),
            lay(last + 1 + t, da["positions"]))
        if caches is not None:
            caches.append(tree_map(torch.clone, cache))
        logits = gather(logits)
        outs.append(logits)
        nxt = logits.argmax(-1)
    return first, torch.cat(fed, 1), torch.stack(outs), shapes


def serve_bytes(out: dict, tag: str, model, batch: dict, lay,
                max_len: int) -> None:
    """The bytes a prefill of ``batch`` (cache ``max_len``) and one decode
    step from its cache send over each mesh axis:
    ``{tag}/bytes/prefill/<axis>`` and ``{tag}/bytes/decode/<axis>``."""
    cfg = model.cfg
    pa, da = prefill_axes(cfg), decode_axes(cfg)
    tokens, positions = batch["tokens"], batch["positions"]
    with torch.no_grad():
        with layout.record_traffic() as pre:
            _, cache = model.prefill(
                lay(tokens, pa["tokens"]), lay(positions, pa["positions"]),
                max_len, lay(batch["extra_embeds"], pa["extra_embeds"])
                if "extra_embeds" in batch else None)
        with layout.record_traffic() as dec:
            model.decode_step(cache, lay(tokens[:, -1:], da["tokens"]),
                              lay(positions[..., -1:] + 1,
                                  da["positions"]))
    put_bytes(out, f"{tag}/bytes/prefill", pre)
    put_bytes(out, f"{tag}/bytes/decode", dec)


def put_bytes(out: dict, prefix: str, traffic) -> None:
    for axis, b in traffic.bytes.items():
        out[f"{prefix}/{axis}"] = b


def _meta(z, prefix: str) -> dict:
    """The arrays under ``prefix`` as ``meta`` tensors of their shapes and
    dtypes."""
    return {k[len(prefix) + 1:]: torch.empty(
        z[k].shape, dtype=torch.from_numpy(z[k][:0]).dtype, device="meta")
        for k in z.files if k.startswith(prefix + "/")}


def dry_main(tmp: str, cases=CASES, config=config, meshes=MESHES,
             max_len: int = MAX_LEN) -> None:
    """The dry run of each case's prefill, decode step and train step on
    each mesh (rank 0; the smoke depths run whole) at the inputs' shapes
    -> ``dry.json``:
    ``{case/mesh: {kind: bytes by axis}}``."""
    from repro_torch.launch.dryrun import measure
    z = np.load(os.path.join(tmp, "inputs.npz"))
    res = {}
    for case in cases:
        cfg = config(case)
        batch, train = _meta(z, f"{case}/batch"), _meta(z, f"{case}/train")
        B, S = batch["tokens"].shape[:2]
        runs = {"prefill": (ShapeSpec("prefill", S, B, "prefill"), batch),
                "decode": (ShapeSpec("decode", max_len, B, "decode"), None),
                "train": (ShapeSpec("train", S, B, "train"), train)}
        for shape in meshes:
            res[f"{case}/{mesh_tag(shape)}"] = {
                kind: measure(cfg, spec, shape, inputs=inputs,
                              max_len=max_len)["collectives"]["by_axis"]
                for kind, (spec, inputs) in runs.items()}
    with open(os.path.join(tmp, "dry.json"), "w") as f:
        json.dump(res, f)


def start_dry(tmp, module: str) -> subprocess.Popen:
    """``module.dry_main(tmp)`` in a process of its own, started now."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = [os.path.join(os.path.dirname(here), "src"), here]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        path + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.Popen(
        [sys.executable, "-c", f"import {module} as m; m.dry_main({str(tmp)!r})"],
        env=env, cwd=here)


def _one_device(case, cfg, tree, z, out) -> None:
    """The port's one-device forward, prefill + greedy decode, and the
    gradient and one step at each row split a mesh needs."""
    model = build(cfg, device="cpu").load_tree(tree)
    batch = _tensors(z, f"{case}/batch")
    with torch.no_grad():
        logits, aux = model.forward(batch["tokens"], batch["positions"],
                                    batch.get("extra_embeds"))
    out[f"one/{case}/logits"] = logits.numpy()
    out[f"one/{case}/aux"] = float(aux)
    first, fed, steps, _ = greedy(model, batch)
    out[f"one/{case}/prefill"] = first.numpy()
    out[f"one/{case}/fed"] = fed.numpy()
    out[f"one/{case}/decode"] = steps.numpy()
    train = _tensors(z, f"{case}/train")
    meta = build(cfg, device="meta")
    for shards in sorted({split_rows(case, s) for s in MESHES}):
        masters = tree_map(lambda t: t.clone().requires_grad_(), tree)
        rows = B // shards
        losses = [backward_into(meta, masters, {
            k: (v[0][:, j * rows:(j + 1) * rows] if k == "positions"
                else v[0][j * rows:(j + 1) * rows])
            for k, v in train.items()}) for j in range(shards)]
        tag = f"one/{case}/split{shards}"
        out[f"{tag}/loss"] = sum(float(x) for x in losses) / len(losses)
        grads = tree_map(lambda m: m.grad / len(losses), masters)
        _put(out, f"{tag}/grads", grads)
        opt = AdamWConfig(**OPT)
        state, _ = apply_updates(init_state(tree_map(torch.clone, tree),
                                            opt), grads, opt)
        for part in ("params", "m", "v"):
            _put(out, f"{tag}/{part}", getattr(state, part))


def _weight_ok(ctx, model) -> list[str]:
    """Leaves whose local shape is not the spec's shard of the declared
    shape (one layer of a stacked leaf)."""
    bad = []
    for path, p in leaves(model.decls()):
        t = model.leaf(path)
        if path[0] == "layers":
            want = ctx.sharding(p.shape, p.axes).shard_shape(p.shape)[1:]
            t = t[0]
        else:
            want = ctx.sharding(p.shape, p.axes).shard_shape(p.shape)
        if tuple(t.shape) != want:
            bad.append(key(path))
    return bad


def step_blocks(step, state, model) -> bool:
    """Whether every parameter the ZeRO step computes on (``gathered``:
    this rank's shards gathered over the data axes) is this rank's block
    under its ``ShardCtx.model_spec``: the step computes tensor
    parallel.  A collective: every rank calls it."""
    decls = [p for _, p in leaves(model.decls())]
    want = [model.ctx.model_block(p.shape, p.axes) for p in decls]
    got = [tuple(t.shape) for t in step.gathered(state.params)]
    return got == want and any(w != p.shape for w, p in zip(want, decls))


def _mesh_case(rank, case, cfg, tree, z, mesh, tag, out) -> None:
    ctx = ShardCtx(mesh, merged_rules(mesh))
    model = build(cfg, ctx, device="cpu").load_tree(tree)
    out[f"{tag}/bad_weights"] = np.array(_weight_ok(ctx, model), dtype=str)
    batch = _tensors(z, f"{case}/batch")
    pa = prefill_axes(cfg)
    lay = lambda t, axes: ctx.local(t, *axes)
    whole = lambda t: ctx.gather_rows(model.gather_vocab(t), B)
    with torch.no_grad(), Legs() as legs, layout.record_traffic() as fwd:
        logits, aux = model.forward(
            *(lay(batch[k], pa[k]) for k in ("tokens", "positions")),
            lay(batch["extra_embeds"], pa["extra_embeds"])
            if "extra_embeds" in batch else None)
    out[f"{tag}/fwd_records"] = np.array(
        [[op, axis, ",".join(map(str, s))]
         for op, axis, s in fwd.calls], dtype=str)
    out[f"{tag}/legs"] = np.array([legs.n[k] for k in ("cp", "ep",
                                                       "moe_mlp")])
    logits = whole(logits)
    out[f"{tag}/aux"] = float(aux)
    with layout.record_traffic() as dec:
        first, fed, steps, shapes = greedy(model, batch, lay, whole)
    out[f"{tag}/decode_records"] = np.array(
        [[op, axis, ",".join(map(str, s))]
         for op, axis, s in dec.calls], dtype=str)
    for k, s in shapes.items():
        out[f"{tag}/cache/{key(k)}"] = np.array(s)
    serve_bytes(out, tag, model, batch, lay, MAX_LEN)
    if rank == 0:
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
    loss, grads = step.grads(state, train)
    out[f"{tag}/grads_loss"] = float(loss)
    full = [layout.gather(g, s) for (_, g), (_, s) in zip(leaves(grads),
                                                          leaves(gsh))]
    if rank == 0:
        for (path, _), g in zip(leaves(grads), full):
            out[f"{tag}/grads/{key(path)}"] = g.numpy()
    with layout.record_traffic() as trained:
        state, metrics = step(state, train, 0)
    put_bytes(out, f"{tag}/bytes/train", trained)
    out[f"{tag}/loss"] = float(metrics["loss"])
    for part, sh in (("params", psh), ("m", gsh), ("v", gsh)):
        tree_ = getattr(state, part)
        _put(out, f"{tag}/local/{part}", tree_)
        full = [layout.gather(t, s) for (_, t), (_, s) in zip(
            leaves(tree_), leaves(sh))]
        if rank == 0:
            for (path, _), t in zip(leaves(tree_), full):
                out[f"{tag}/{part}/{key(path)}"] = t.numpy()


def _legs(z, mesh, out) -> None:
    """The attention legs at the reference test's shapes, on this mesh
    and on one device."""
    ctx = ShardCtx(mesh, merged_rules(mesh))
    q, k, v = (torch.from_numpy(z[f"cp/{n}"]) for n in "qkv")
    kw = dict(scale=SCALE, q_chunk=CP_CHUNK, k_chunk=CP_CHUNK)
    out["cp/one"] = attention.chunked_attention(q, k, v, **kw).numpy()
    with Legs() as legs, layout.record_traffic() as cp:
        out["cp/got"] = attention.chunked_attention(q, k, v, ctx=ctx,
                                                    **kw).numpy()
    out["cp/legs"] = legs.n["cp"]
    out["cp/records"] = len(cp.calls)
    q2, kc, vc = (torch.from_numpy(z[f"dec/{n}"]) for n in ("q", "k", "v"))
    ln = torch.from_numpy(z["dec/len"])
    out["dec/one"] = attention.decode_attention(q2, kc, vc, ln,
                                                scale=SCALE).numpy()
    cax = ("batch", None, "kv", "head_dim")
    with layout.record_traffic() as dec:
        out["dec/got"] = attention.decode_attention(
            q2, kc, vc, ln, scale=SCALE, ctx=ctx).numpy()
        # the cache as cache_axes lays it out: this rank's head_dim slice
        out["dec/got_local"] = attention.decode_attention(
            q2, ctx.local(kc, *cax), ctx.local(vc, *cax), ln, scale=SCALE,
            ctx=ctx).numpy()
    out["dec/records"] = np.array(
        [[op, axis, ",".join(map(str, s))]
         for op, axis, s in dec.calls], dtype=str)


def tp_main(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)       # four ranks share the host's cores
    z = np.load(os.path.join(tmp, "inputs.npz"))
    out: dict = {}
    meshes = {shape: make_debug_mesh(*shape, device_type="cpu")
              for shape in MESHES}
    for case in CASES:
        cfg = config(case)
        tree = _tree(z, case, cfg)
        if rank == 0:
            _one_device(case, cfg, tree, z, out)
        for shape, mesh in meshes.items():
            _mesh_case(rank, case, cfg, tree, z, mesh,
                       f"{case}/{mesh_tag(shape)}", out)
    _legs(z, meshes[(1, 4)], out)
    out["coordinate"] = np.array([meshes[s].get_coordinate()
                                  for s in MESHES])
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)

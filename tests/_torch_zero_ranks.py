"""The rank program of ``tests/test_torch_zero.py``.

``zero_main(rank, tmp)`` runs on every rank of a ``gloo`` world of 4
that ``repro_torch.launch.mesh.spawn`` starts on the CPU.  It reads the
numpy inputs (``inputs.npz``: each config's parameter tree and batches)
from ``tmp``, builds the (2, 2) and (1, 4) debug meshes in that one world
and runs on them:

* the ZeRO step (``make_train_step(..., grad_shardings=,
  param_shardings=)``) of each config: its loss and gradient shards
  (``step.grads``) and one step, and the port's one-device step on the
  same tree in this process;
* a batch that does not divide the data axis, and the same batch with
  the gradients laid out over the model axis alone (``_data_group``);
* a checkpoint saved on (2, 2), restored on one device, on (1, 4) and
  back on (2, 2);
* ``TrainLoop(state_shardings=)``: uninterrupted, failing and resumed,
  and with a straggler on rank 3 alone;
* ``ShardCtx.constrain`` on a DTensor.

Each rank writes what it computed to ``rank<rank>.npz``: its local
shards, and on rank 0 the gathered tensors and the one-device results.
This module imports neither JAX nor the reference package, so a rank
starts with the port alone.
"""
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import ShardCtx, build
from repro_torch.models.base import leaves, tree_map, unflatten
from repro_torch.sharding.layout import Sharding, entry_names, gather
from repro_torch.sharding.rules import act_rules, merged_rules
from repro_torch.train import (AdamWConfig, CheckpointManager, RuntimeConfig,
                               SimulatedFailure, TrainLoop, apply_updates,
                               init_state,
                               make_train_step, shard_state, state_shardings,
                               zero_shardings)
from repro_torch.train.step import backward_into

CONFIGS = ("llama3-8b", "deepseek-v2-lite-16b")
MESHES = ((2, 2), (1, 4))
ACCUM, B, S, B_ODD = 2, 4, 32, 3
OPT = dict(lr=1e-3, warmup_steps=1)
LOOP_STEPS, LOOP_SAVE, LOOP_FAIL = 8, 3, 5
STRAGGLER_RANK, STRAGGLER_CALL = 3, 7
# The MoE load-balance loss is a product of two batch means, so it is not
# the mean of its data shards' values; the ZeRO step takes it per data
# shard, as the reference's expert-parallel path does on a mesh
# (``_routed_ep``: ``pmean`` of each shard's).  Cases where it meets a
# data axis > 1 are held to the one-device step on that many row slices.
SPLIT = {("deepseek-v2-lite-16b", (2, 2)): 2}


def config(name: str):
    return dataclasses.replace(get_config(name).smoke(), dtype="float32")


def key(path) -> str:
    return "/".join(map(str, path))


def mesh_tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def _host_tree(z, name: str, cfg):
    decls = build(cfg, device="meta").decls()
    return tree_map(lambda path, _: torch.from_numpy(
        z[f"{name}/tree/{key(path)}"].copy()), decls, with_path=True)


def _put(out: dict, prefix: str, tree) -> None:
    for path, t in leaves(tree):
        out[f"{prefix}/{key(path)}"] = t.detach().numpy().copy()


def _gathered(tree, shardings) -> dict:
    return unflatten(tree, [gather(t, s) for (_, t), (_, s) in
                            zip(leaves(tree), leaves(shardings))])


def one_tag(name: str, batch: int, shards: int = 1) -> str:
    return f"one/{name}/{batch}" + (f"/split{shards}" if shards > 1 else "")


def _one_device(name, cfg, host, tokens, out, shards: int = 1) -> None:
    """The port's one-device gradient (``backward_into``, the mean over
    the microbatches and over ``shards`` equal row slices of each, each
    slice's loss its own) and step on the full tree: the train step
    itself for one slice, ``apply_updates`` on that gradient else."""
    model = build(cfg, device="meta")
    masters = tree_map(lambda t: t.clone().requires_grad_(), host)
    rows = tokens.shape[1] // shards
    losses = [backward_into(model, masters, {"tokens": torch.from_numpy(
        tokens[i, j * rows:(j + 1) * rows])})
        for i in range(tokens.shape[0]) for j in range(shards)]
    tag = one_tag(name, tokens.shape[1], shards)
    out[f"{tag}/loss"] = np.float32(sum(float(x) for x in losses)
                                    / len(losses))
    grads = tree_map(lambda m: m.grad / len(losses), masters)
    _put(out, f"{tag}/grads", grads)
    opt = AdamWConfig(**OPT)
    state = init_state(tree_map(torch.clone, host), opt)
    if shards == 1:
        state, metrics = make_train_step(model, opt, device="cpu")(
            state, {"tokens": tokens}, 0)
    else:
        state, metrics = apply_updates(state, grads, opt)
    out[f"{tag}/grad_norm"] = float(metrics["grad_norm"])
    for part in ("params", "m", "v"):
        _put(out, f"{tag}/{part}", getattr(state, part))


def _case(rank, name, cfg, host, tokens, mesh, tag, out):
    """One config on one mesh: the ZeRO step's gradient and one step."""
    model = build(cfg, ShardCtx(mesh, merged_rules(mesh)), device="meta")
    psh, gsh = zero_shardings(model, mesh)
    opt = AdamWConfig(**OPT)
    state = shard_state(host, opt, psh, gsh)
    step = make_train_step(model, opt, gsh, param_shardings=psh,
                           device="cpu")
    loss, grads = step.grads(state, {"tokens": tokens})
    out[f"{tag}/grads_loss"] = float(loss)
    _put(out, f"{tag}/local/grads", grads)
    full = _gathered(grads, gsh)
    if rank == 0:
        _put(out, f"{tag}/grads", full)
    state, metrics = step(state, {"tokens": tokens}, 0)
    for k, v in metrics.items():
        out[f"{tag}/metric/{k}"] = float(v)
    for part, sh in (("params", psh), ("m", gsh), ("v", gsh)):
        _put(out, f"{tag}/local/{part}", getattr(state, part))
        full = _gathered(getattr(state, part), sh)
        if rank == 0:
            _put(out, f"{tag}/{part}", full)
    return model, psh, gsh, state


def _data_group(rank, model, host, tokens, psh, tag, out) -> None:
    """The gradient of a batch that every data rank holds whole, laid out
    over the model axis alone: each data group computes it tensor
    parallel on its own model axis, and nothing crosses the data axis."""
    mesh = model.ctx.mesh
    msh = tree_map(lambda s: Sharding(mesh, tuple(
        "model" if "model" in entry_names(e) else None for e in s.spec)),
        psh)
    opt = AdamWConfig(**OPT)
    step = make_train_step(model, opt, msh, param_shardings=psh,
                           device="cpu")
    loss, grads = step.grads(shard_state(host, opt, psh, msh),
                             {"tokens": tokens})
    out[f"{tag}/grads_loss"] = float(loss)
    _put(out, f"{tag}/local/grads", grads)
    full = _gathered(grads, msh)
    if rank == 0:
        _put(out, f"{tag}/grads", full)


def _checkpoints(rank, cfg, host, state, psh, gsh, mesh14, tmp, out):
    """Save the (2, 2) state; restore it on one device, on (1, 4) and on
    (2, 2), each bitwise against the gathered state."""
    opt = AdamWConfig(**OPT)
    ckpt = os.path.join(tmp, "ckpt")
    sh22 = state_shardings(psh, gsh)
    CheckpointManager(ckpt).save(1, state, shardings=sh22)
    full = {part: _gathered(getattr(state, part), getattr(sh22, part))
            for part in ("params", "m", "v")}
    if rank == 0:
        for part, tree in full.items():
            _put(out, f"ckpt/{part}", tree)
    zeros = tree_map(torch.zeros_like, host)
    one, step = CheckpointManager(ckpt).restore(init_state(zeros, opt))
    out["ckpt/one_step"] = step
    out["ckpt/one_equal"] = int(one.step) == 1 and all(
        torch.equal(a, b) for part in full
        for (_, a), (_, b) in zip(leaves(getattr(one, part)),
                                  leaves(full[part])))
    p14, g14 = zero_shardings(build(cfg, device="meta"), mesh14)
    sh14 = state_shardings(p14, g14)
    got, _ = CheckpointManager(ckpt).restore(
        shard_state(zeros, opt, p14, g14), shardings=sh14)
    out["ckpt/m14_equal"] = all(
        torch.equal(a, s.place(b)) for part in full
        for (_, a), (_, s), (_, b) in zip(
            leaves(getattr(got, part)), leaves(getattr(sh14, part)),
            leaves(full[part])))
    _put(out, "ckpt/m14_local/params", got.params)
    back, _ = CheckpointManager(ckpt).restore(
        shard_state(zeros, opt, psh, gsh), shardings=sh22)
    out["ckpt/m22_equal"] = all(
        torch.equal(a, b) for part in ("params", "m", "v")
        for (_, a), (_, b) in zip(leaves(getattr(back, part)),
                                  leaves(getattr(state, part))))


def _loop(model, host, psh, gsh, tokens, ckpt_dir, **rt):
    opt = AdamWConfig(**OPT)
    step = make_train_step(model, opt, gsh, param_shardings=psh,
                           device="cpu")

    def data():
        while True:
            yield {"tokens": tokens}
    return TrainLoop(step, shard_state(host, opt, psh, gsh), data(),
                     RuntimeConfig(ckpt_dir=ckpt_dir, max_steps=LOOP_STEPS,
                                   save_every=LOOP_SAVE, heartbeat_every=4,
                                   **rt),
                     state_shardings=state_shardings(psh, gsh),
                     device="cpu")


def _loops(rank, model, host, psh, gsh, tokens, tmp, out):
    """Uninterrupted, failing at LOOP_FAIL and resumed, and a straggler
    on one rank only."""
    ref = _loop(model, host, psh, gsh, tokens, os.path.join(tmp, "ref"))
    final = ref.run(seed=0)
    out["loop/ref_losses"] = np.array([m["loss"] for m in ref.metrics_log])
    failing = _loop(model, host, psh, gsh, tokens, os.path.join(tmp, "ft"),
                    fail_at_step=LOOP_FAIL)
    try:
        failing.run(seed=0)
        out["loop/raised"] = False
    except SimulatedFailure:
        out["loop/raised"] = True
    failing.mgr.wait()
    out["loop/published"] = failing.mgr.latest_step()
    resumed = _loop(model, host, psh, gsh, tokens, os.path.join(tmp, "ft"))
    got = resumed.run(seed=0)
    out["loop/resumed_losses"] = np.array(
        [m["loss"] for m in resumed.metrics_log])
    out["loop/final_equal"] = all(
        torch.equal(a, b) for part in ("params", "m", "v")
        for (_, a), (_, b) in zip(leaves(getattr(got, part)),
                                  leaves(getattr(final, part))))

    slow = _loop(model, host, psh, gsh, tokens, os.path.join(tmp, "slow"),
                 straggler_patience=1)
    orig, calls = slow.train_step, {"n": 0, "max": 0.0}

    def wrapped(state, batch, seed):
        calls["n"] += 1
        if rank == STRAGGLER_RANK and calls["n"] == STRAGGLER_CALL:
            time.sleep(1.5 + 10 * calls["max"])
        t0 = time.perf_counter()
        res = orig(state, batch, seed)
        calls["max"] = max(calls["max"], time.perf_counter() - t0)
        return res
    slow.train_step = wrapped
    slow.run(seed=0)
    out["loop/straggler_events"] = slow.straggler_events
    out["loop/slow_steps"] = np.array(slow.mgr.steps())


def _constrain(mesh, out):
    from torch.distributed.tensor import DTensor, Replicate
    ctx = ShardCtx(mesh, act_rules(mesh))
    x = DTensor.from_local(torch.arange(32.0).reshape(8, 4), mesh,
                           [Replicate(), Replicate()])
    y = ctx.constrain(x, "batch", None)
    out["constrain/placements"] = str(tuple(y.placements))
    out["constrain/local"] = y.to_local().numpy()
    plain = torch.zeros(8, 4)
    out["constrain/plain_is_same"] = ctx.constrain(plain, "batch",
                                                   None) is plain


def zero_main(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)       # four ranks share the host's cores
    z = np.load(os.path.join(tmp, "inputs.npz"))
    out: dict = {}
    meshes = {shape: make_debug_mesh(*shape, device_type="cpu")
              for shape in MESHES}
    kept = {}
    for name in CONFIGS:
        cfg = config(name)
        host = _host_tree(z, name, cfg)
        tokens = z[f"{name}/tokens"]
        _one_device(name, cfg, host, tokens, out)
        for shape, mesh in meshes.items():
            if (name, shape) in SPLIT:
                _one_device(name, cfg, host, tokens, out,
                            SPLIT[name, shape])
            kept[name, shape] = _case(rank, name, cfg, host, tokens, mesh,
                                      f"{name}/{mesh_tag(shape)}", out)
    name, shape = CONFIGS[0], MESHES[0]
    cfg = config(name)
    host = _host_tree(z, name, cfg)
    odd = z[f"{name}/tokens_odd"]
    _one_device(name, cfg, host, odd, out)
    odd_model, odd_psh, _, _ = _case(rank, name, cfg, host, odd,
                                     meshes[shape], f"odd/{name}", out)
    _data_group(rank, odd_model, host, odd, odd_psh, f"odd/{name}/group",
                out)
    model, psh, gsh, state = kept[name, shape]
    _checkpoints(rank, cfg, host, state, psh, gsh, meshes[MESHES[1]], tmp,
                 out)
    _loops(rank, model, host, psh, gsh, z[f"{name}/tokens"][:1], tmp, out)
    _constrain(meshes[shape], out)
    out["coordinate"] = np.array([meshes[s].get_coordinate()
                                  for s in MESHES])
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)

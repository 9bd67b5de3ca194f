"""The LM training step: bf16 compute over f32 master weights, gradient
accumulation (the port of ``repro.train.step``).

``make_train_step(model, opt_cfg)`` returns

    train_step(state, batch, seed) -> (state, metrics)

* ``batch`` has a leading gradient-accumulation axis; the microbatches
  run one after another, so activation memory is one microbatch's;
* each microbatch casts the f32 master tree to the model's compute dtype
  ONCE (``cast_tree``) and runs the model on that tree
  (``StackedLM.bound``), as the reference's grad function does.  A leaf
  used more than once (gemma's tied embedding at the input and the
  logits, zamba2's shared block at every invocation) therefore sums its
  cotangents in the compute dtype, and the one cast back to f32 comes
  after the sum, as in the reference; a cast at each use would sum them
  in f32;
* the gradients accumulate in ``cfg.grad_accum_dtype`` in the
  reference's order, 0 + g1 + g2 + ..., and are divided by the number
  of microbatches before ``apply_updates``.  In f32 the accumulator is
  the master leaves' ``.grad``, which autograd adds into in place as
  each leaf's gradient arrives (adding to zero first is exact);
* ``seed`` is taken and unused, as in the reference (no dropout).

``make_train_step(model, opt_cfg, grad_shardings, param_shardings=)`` is
the ZeRO step on a mesh (``ShardedStep``): the state's tensors are each
rank's shards, the parameters laid out by ``param_shardings``
(``param_rules``), the moments and the gradients by ``grad_shardings``
(``opt_rules``: split over the data axes too).  Every rank runs it:

* it takes its data slice of the global batch (``launch.specs
  .train_batch_axes``: the batch dim over the data axes, whole where it
  does not divide them);
* it computes tensor parallel, for every family of the LM stack: it
  casts its master shards to the compute dtype once a step and gathers
  them over the data axes only (where ``zero3`` splits "embed"), so each
  rank holds its block over the model axis and never a full copy of a
  leaf that the rules split over it; the model (built with a
  ``ShardCtx`` on the step's mesh) computes on the blocks, and its loss,
  the same on every rank of the model axis, seeds the backward with
  1 / model (``sharding.layout``: a tensor every model rank holds stands
  for the sum over them);
* as the backward finishes each leaf's gradient, it reduces it, in
  f32, into this rank's shard of ``grad_shardings`` (a reduce-scatter
  over the data axes, as GSPMD does for the reference's constraint, and
  an all-reduce over the model axis of the leaves that the model axis
  does not split, whose gradients are partial sums over it) and frees
  the full one; the accumulators hold the shards only;
* gradients and loss are averaged over the data ranks, so they are those
  of the global batch's mean; ``apply_updates`` then updates the
  moments' block of each parameter and gathers it over the data axes.

The collectives are explicit calls on the local shards
(``sharding.layout``); each rank makes the same calls in the same order.
The sums run in another order than on one device, so losses and
gradients agree with one device to rounding, not bit for bit.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..launch.mesh import axis_sizes
from ..launch.specs import train_batch_axes
from ..models.base import ShardCtx, leaves, tree_map, unflatten
from ..models.config import torch_dtype
from ..sharding.layout import (Sharding, entry_names, gather, gather_scalar,
                               reduce_shard)
from ..sharding.rules import act_rules, opt_rules, param_rules
from .optimizer import AdamWConfig, TrainState, apply_updates


def cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    """Every floating leaf of a tree of dicts and lists cast to
    ``dtype``; other leaves as they are."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


def _grad(leaf: torch.Tensor) -> torch.Tensor:
    """A master leaf's gradient; zeros for a leaf the loss does not reach
    (the reference's gradient of an unused leaf)."""
    return leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


def backward_into(model, masters: Any, microbatch: dict) -> torch.Tensor:
    """One microbatch's grad function: cast the master tree (leaves that
    require grad) once to the model's compute dtype, run ``model.loss`` on
    that tree and backpropagate, inside ``model.bound`` (a remat layer's
    recompute reads the same tree).  Each master's ``.grad`` receives (or
    adds) its gradient.  -> the loss, detached."""
    tree = cast_tree(masters, torch_dtype(model.cfg.dtype))
    with model.bound(tree):
        loss, _ = model.loss(microbatch)
        loss.backward()
    return loss.detach()


def zero_shardings(model, mesh) -> tuple[Any, Any]:
    """(param_shardings, grad_shardings) of ``model``'s declarations on
    ``mesh``, as the reference's launcher lays out a train cell: the
    parameters by ``param_rules`` (ZeRO-3 where ``cfg.zero3``), the
    moments and gradients by ``opt_rules``."""
    decls = model.decls()
    return (ShardCtx(mesh, param_rules(mesh, zero3=model.cfg.zero3))
            .param_shardings(decls),
            ShardCtx(mesh, opt_rules(mesh)).param_shardings(decls))


def make_train_step(model, opt_cfg: AdamWConfig, grad_shardings=None, *,
                    param_shardings=None,
                    device: str | torch.device | None = None) -> Callable:
    """The step for ``model`` (a ``StackedLM``; its own parameters may
    live on ``"meta"``: the step runs it on the state's tree) on
    ``device`` (default ``cuda``, raising without a card): the state's
    tensors must be there, the batch (tensors or numpy) is moved there.
    With ``grad_shardings`` and ``param_shardings`` (trees of
    ``sharding.layout.Sharding``, the state's parameter tree's structure)
    the ZeRO step on their mesh (``ShardedStep``)."""
    if (grad_shardings is None) != (param_shardings is None):
        raise ValueError("a sharded step takes both grad_shardings (the "
                         "moments' layout) and param_shardings")
    if grad_shardings is not None:
        return ShardedStep(model, opt_cfg, param_shardings, grad_shardings,
                           device=device)
    dev = resolve_device(device)
    cfg = model.cfg
    accum_dtype = torch_dtype(getattr(cfg, "grad_accum_dtype", "float32"))

    def train_step(state: TrainState, batch: dict, seed=None):
        batch = _to_device(batch, dev)
        accum = next(iter(batch.values())).shape[0]
        masters = [p.detach().requires_grad_()
                   for _, p in leaves(state.params)]
        in_grad = all(m.dtype == accum_dtype for m in masters)
        acc = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        tree = unflatten(state.params, masters)
        for i in range(accum):
            loss = backward_into(model, tree, {k: v[i]
                                               for k, v in batch.items()})
            loss_sum = loss_sum + loss
            if not in_grad:
                # a narrower accumulator: fold each microbatch's gradient
                # in, in the reference's order
                g = [_grad(m).to(accum_dtype) for m in masters]
                acc = g if acc is None else [a + b for a, b in zip(acc, g)]
                del g    # not held through the next microbatch's backward
                for m in masters:
                    m.grad = None
        grads = [_grad(m) for m in masters] if in_grad else acc
        for g in grads:
            g.div_(accum)            # the accumulators are the step's own
        grads = unflatten(state.params, grads)
        del masters, tree, acc
        new_state, opt_metrics = apply_updates(state, grads, opt_cfg)
        return new_state, {"loss": loss_sum / accum, **opt_metrics}

    return train_step


class ShardedStep:
    """The ZeRO train step on a mesh (module docstring): ``step(state,
    batch, seed) -> (state, metrics)`` on every rank, the state's tensors
    this rank's shards; ``step.grads(state, batch)`` gives the loss and
    the gradient shards alone.  The model computes tensor parallel on
    the step's mesh."""

    def __init__(self, model, opt_cfg: AdamWConfig, param_shardings,
                 grad_shardings, *,
                 device: str | torch.device | None = None):
        self.opt_cfg = opt_cfg
        self.param_shardings = param_shardings
        self.grad_shardings = grad_shardings
        self.device = resolve_device(device)
        self._p = [s for _, s in leaves(param_shardings)]
        self._g = [s for _, s in leaves(grad_shardings)]
        self.mesh = self._g[0].mesh
        if model.ctx.mesh is not self.mesh:
            raise ValueError(
                f"{model.cfg.name} computes tensor parallel on the step's "
                f"mesh: build it with ShardCtx(mesh, merged_rules(mesh))")
        self.model = model
        self.n_model = axis_sizes(self.mesh).get("model", 1)
        strip = lambda s: Sharding(self.mesh, tuple(
            None if "model" in entry_names(e) else e for e in s.spec))
        # the data-axis part of each layout, and the leaves whose
        # gradients are partial sums over the model axis
        self._data_p = [strip(s) for s in self._p]
        self._data_g = [strip(s) for s in self._g]
        self._partial = [self.n_model > 1 and not any(
            "model" in entry_names(e) for e in s.spec) for s in self._p]
        self._batch_ctx = ShardCtx(self.mesh, act_rules(self.mesh))
        self._axes = train_batch_axes(model.cfg)
        self.compute_dtype = torch_dtype(model.cfg.dtype)
        self.accum_dtype = torch_dtype(getattr(model.cfg,
                                               "grad_accum_dtype",
                                               "float32"))

    def local_batch(self, batch: dict) -> tuple[dict, tuple[str, ...]]:
        """(this rank's slice of the global batch, the mesh axes that
        split it)."""
        batch = _to_device(batch, self.device)
        shs = {k: self._batch_ctx.sharding(v.shape, self._axes[k])
               for k, v in batch.items()}
        split = {a for s in shs.values() for e in s.spec
                 for a in entry_names(e)}
        over = tuple(a for a in axis_sizes(self.mesh) if a in split)
        return {k: shs[k].local(v) for k, v in batch.items()}, over

    def gathered(self, params) -> list[torch.Tensor]:
        """Each master shard cast to the compute dtype once and gathered
        over the data axes only, to this rank's block over the model axis,
        a new autograd leaf, in tree order."""
        return [gather(p.detach().to(self.compute_dtype), s).detach()
                .requires_grad_() for (_, p), s in zip(leaves(params),
                                                       self._data_p)]

    def _mean(self, x: torch.Tensor, over: tuple[str, ...]) -> torch.Tensor:
        """The mean of the ranks' scalar ``x`` over the axes ``over`` (one
        rank of each other axis), the same bits on every rank."""
        vals = gather_scalar(x, self.mesh)
        names = list(axis_sizes(self.mesh))
        vals = vals[tuple(slice(None) if a in over else 0 for a in names)]
        return vals.sum() / vals.numel()

    def grads(self, state: TrainState, batch: dict):
        """-> (the loss, the gradient shards in ``grad_shardings``' tree):
        the mean over the global batch and the microbatches.  Each leaf's
        gradient is reduced as soon as the backward has finished it (a
        post-accumulate-grad hook), so the full gradients are never all
        held at once; the backward reaches the leaves in the same order
        on every rank (the same graph), so the ranks' collectives
        match."""
        local, over = self.local_batch(batch)
        sizes = axis_sizes(self.mesh)
        n_over = math.prod(sizes[a] for a in over)
        accum = next(iter(local.values())).shape[0]
        full = self.gathered(state.params)
        tree = unflatten(state.params, full)
        acc: list = [None] * len(full)
        todo: set = set()

        def fold(j: int, g: torch.Tensor) -> None:
            g = reduce_shard(g, self._data_g[j], over + (
                ("model",) if self._partial[j] else ()), torch.float32)
            if n_over > 1:
                g = g / n_over
            g = g.to(self.accum_dtype)
            acc[j] = g if acc[j] is None else acc[j] + g
            todo.discard(j)

        def hook(j: int):
            def run(x: torch.Tensor) -> None:
                g, x.grad = x.grad, None
                fold(j, g)
            return run
        handles = [x.register_post_accumulate_grad_hook(hook(j))
                   for j, x in enumerate(full)]
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        try:
            for i in range(accum):
                todo.update(range(len(full)))
                with self.model.bound(tree):
                    loss, _ = self.model.loss({k: v[i] for k, v in
                                               local.items()})
                    (loss / self.n_model).backward()
                loss_sum = loss_sum + loss.detach()
                for j in sorted(todo):     # leaves the loss does not reach
                    fold(j, torch.zeros_like(full[j]))
        finally:
            for h in handles:
                h.remove()
        del full, tree
        for a in acc:
            a.div_(accum)
        return (self._mean(loss_sum / accum, over),
                unflatten(state.params, acc))

    def __call__(self, state: TrainState, batch: dict, seed=None):
        loss, grads = self.grads(state, batch)
        new_state, opt_metrics = apply_updates(
            state, grads, self.opt_cfg,
            param_shardings=self.param_shardings,
            grad_shardings=self.grad_shardings)
        return new_state, {"loss": loss, **opt_metrics}

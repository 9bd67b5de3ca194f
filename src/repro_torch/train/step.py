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

The reference's ZeRO ``grad_shardings`` (a mesh leg) is not ported: a
value other than None raises.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..models.base import leaves, tree_map, unflatten
from ..models.config import torch_dtype
from .optimizer import AdamWConfig, TrainState, apply_updates

MESH_LEG = ("ZeRO gradient and state shardings belong to the LM stack's "
            "mesh legs (ROADMAP, Queue 1 item 13, \"The LM stack's mesh "
            "legs\"), not ported yet: the port trains on one device")


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


def make_train_step(model, opt_cfg: AdamWConfig, grad_shardings=None, *,
                    device: str | torch.device | None = None) -> Callable:
    """The step for ``model`` (a ``StackedLM``; its own parameters may
    live on ``"meta"``: the step runs it on the state's tree) on
    ``device`` (default ``cuda``, raising without a card): the state's
    tensors must be there, the batch (tensors or numpy) is moved there."""
    if grad_shardings is not None:
        raise NotImplementedError(MESH_LEG)
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

"""AdamW with f32 master weights and dtype-configurable moments (the port
of ``repro.train.optimizer``).

The ``TrainState`` holds the f32 master parameters and the first and
second moments, stored in ``AdamWConfig.moment_dtype`` (bf16 for
grok-1-314b) and updated in f32: clip by global norm, bias corrections,
decoupled weight decay, the reference's formulas op for op.

Trees are nested dicts and lists of tensors (``models.base.leaves`` /
``tree_map``), the reference's pytrees.  ``apply_updates`` writes the new
parameters and moments into the state's tensors in place and returns a
``TrainState`` over them: the reference returns new arrays, but eager
PyTorch would then hold two states at once (2 x 33.5 GB for llama3-8b
eight layers deep).  Plain PyTorch: the reference has no Pallas kernel
here.

On a mesh (ZeRO, ``train.step``'s sharded step) each tensor is this
rank's shard: the gradients and moments in one layout (``opt_rules``,
split over the data axes too), the parameters in another
(``param_rules``).  ``apply_updates(..., param_shardings=,
grad_shardings=)`` then does what the reference's GSPMD does: the norm
over the global tensors, each element counted once (a leaf that the
model axis replicates is counted by one rank of it); the update on the
moments' block of each parameter, which all the data ranks then gather
into the parameters' layout.  Every rank sums the ranks' partial norms
in the same order, so the clip factor, and with it every replicated
parameter, is the same bits on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models.base import leaves, tree_map, unflatten
from ..numerics import sqrt_rn
from ..sharding.layout import all_gather_dim, entry_names, gather_scalar

F32 = torch.float32
Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    moment_dtype: torch.dtype = torch.float32

    def schedule(self, step) -> torch.Tensor:
        """Linear warmup -> constant, in f32 (``step`` an int or a
        tensor)."""
        step = torch.as_tensor(step)
        warm = torch.clamp(step.to(F32) / max(self.warmup_steps, 1),
                           max=1.0)
        return self.lr * warm


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor   # () int32
    params: Tree         # f32 master
    m: Tree              # first moment (moment_dtype)
    v: Tree              # second moment (moment_dtype)


def _flat(tree: Tree) -> list[torch.Tensor]:
    return [t for _, t in leaves(tree)]


def init_state(params: Tree, cfg: AdamWConfig) -> TrainState:
    """Zero moments of ``cfg.moment_dtype`` beside ``params`` (kept, not
    copied), step 0 on the device of the first leaf."""
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                  device=p.device)
    first = _flat(params)[0]
    return TrainState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      params=params, m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


def shard_state(params: Tree, cfg: AdamWConfig, param_shardings: Tree,
                moment_shardings: Tree, *, device=None) -> TrainState:
    """``init_state`` on a mesh: this rank's shards of the full parameter
    tree ``params`` (``Sharding.place`` by ``param_shardings``, on
    ``device``, default each leaf's) and zero moments of
    ``moment_shardings``' shard shapes; step 0."""
    flat = _flat(params)
    dev = flat[0].device if device is None else torch.device(device)
    ps = [s for _, s in leaves(param_shardings)]
    ms = [s for _, s in leaves(moment_shardings)]
    zeros = lambda s, p: torch.zeros(s.shard_shape(p.shape),
                                     dtype=cfg.moment_dtype, device=dev)
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        params=unflatten(params, [s.place(p, device=dev)
                                  for s, p in zip(ps, flat)]),
        m=unflatten(params, [zeros(s, p) for s, p in zip(ms, flat)]),
        v=unflatten(params, [zeros(s, p) for s, p in zip(ms, flat)]))


def state_shardings(param_shardings: Tree, moment_shardings: Tree,
                    ) -> TrainState:
    """The layout of a ZeRO state, a ``TrainState`` of shardings (the step
    whole on every rank): what ``TrainLoop(state_shardings=)`` and
    ``CheckpointManager`` take."""
    return TrainState(step=None, params=param_shardings,
                      m=moment_shardings, v=moment_shardings)


def global_norm(tree: Tree, shardings: Tree | None = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, the leaves' sums
    added in tree order as the reference's Python ``sum``.  With
    ``shardings`` (a ``Sharding`` a leaf, the leaves this rank's shards):
    the norm of the global tensors, each rank's partial sum over the
    shards it owns (those at index 0 of every mesh axis that replicates
    them) gathered and added in mesh order, the same bits on every rank.
    A collective then."""
    flat = _flat(tree)
    if shardings is None:
        total = 0
        for g in flat:
            total = total + torch.sum(torch.square(g.to(F32)))
        return sqrt_rn(total)
    sh = [s for _, s in leaves(shardings)]
    total = torch.zeros((), dtype=F32, device=flat[0].device)
    for g, s in zip(flat, sh):
        at = s.coordinate()
        if all(at[a] == 0 for a in s.replicated_axes):
            total = total + torch.sum(torch.square(g.to(F32)))
    return sqrt_rn(gather_scalar(total, sh[0].mesh).sum())


def _update(p, g, m, v, clip, lr, bc1, bc2, cfg: AdamWConfig) -> None:
    """One leaf's AdamW update, in place on ``p`` (f32), ``m`` and
    ``v``."""
    b1, b2 = cfg.beta1, cfg.beta2
    g = g.to(F32) * clip
    m32 = b1 * m.to(F32) + (1 - b1) * g
    v32 = b2 * v.to(F32) + (1 - b2) * torch.square(g)
    del g
    update = (m32 / bc1) / (sqrt_rn(v32 / bc2) + cfg.eps)
    p.sub_(lr * (update + cfg.weight_decay * p))
    del update
    m.copy_(m32)
    v.copy_(v32)


def _block(p: torch.Tensor, p_sh, g_sh) -> tuple[torch.Tensor, list]:
    """The view of the parameter shard ``p`` (layout ``p_sh``) that holds
    the block of layout ``g_sh`` at this rank, and the (dim, axis) pairs
    to gather along afterwards, minor axis first.  Each dim's axes under
    ``g_sh`` must extend those under ``p_sh``."""
    full = p_sh.full_shape(p.shape)
    view, extra = p, []
    for d, ((plo, _), (glo, ghi), pe, ge) in enumerate(zip(
            p_sh.bounds(full), g_sh.bounds(full), p_sh.spec, g_sh.spec)):
        pn, gn = entry_names(pe), entry_names(ge)
        if gn[:len(pn)] != pn:
            raise ValueError(f"dim {d}: the moments' layout {ge!r} does not "
                             f"refine the parameters' {pe!r}")
        if ghi - glo != view.shape[d]:
            view = view.narrow(d, glo - plo, ghi - glo)
        extra += [(d, a) for a in reversed(gn[len(pn):])]
    return view, extra


def apply_updates(state: TrainState, grads: Tree, cfg: AdamWConfig, *,
                  param_shardings: Tree | None = None,
                  grad_shardings: Tree | None = None,
                  ) -> tuple[TrainState, dict]:
    """One AdamW step -> (state over the updated tensors, metrics).  The
    parameters and moments are updated in place (module docstring).  On
    a mesh, ``param_shardings`` lays out ``state.params`` and
    ``grad_shardings`` the gradients and the moments (module docstring);
    every rank calls it."""
    step = state.step + 1
    gnorm = global_norm(grads, grad_shardings)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = cfg.schedule(step)
    bc1 = 1.0 - torch.pow(cfg.beta1, step.to(F32))
    bc2 = 1.0 - torch.pow(cfg.beta2, step.to(F32))

    with torch.no_grad():
        flat = zip(_flat(state.params), _flat(grads), _flat(state.m),
                   _flat(state.v))
        if grad_shardings is None:
            for p, g, m, v in flat:
                _update(p, g, m, v, clip, lr, bc1, bc2, cfg)
        else:
            shs = zip([s for _, s in leaves(param_shardings)],
                      [s for _, s in leaves(grad_shardings)])
            for (p, g, m, v), (p_sh, g_sh) in zip(flat, shs):
                block, extra = _block(p, p_sh, g_sh)
                _update(block, g, m, v, clip, lr, bc1, bc2, cfg)
                if extra:
                    sizes = g_sh.sizes
                    for d, a in extra:
                        block = all_gather_dim(block, g_sh.mesh, a,
                                                sizes[a], d)
                    p.copy_(block)
                    del block
    return (TrainState(step=step, params=state.params, m=state.m,
                       v=state.v),
            {"grad_norm": gnorm, "lr": lr})

"""Carry a model and a programmed system across from arrays.

The functions take plain numpy arrays (or anything ``np.asarray``
accepts), so a system programmed elsewhere, such as by the JAX reference
package, crosses into the port without the port importing it:

    d = dict(clause_g=np.asarray(sys.clause_g), ..., n_literals=...,
             program_energy_j=..., erase_energy_j=...)
    system = system_from_arrays(d, device="cuda")

``lm_params_from_arrays`` does the same for an LM's parameter tree (the
reference's layout, stacked ``"layers"`` axis), and ``lm_arrays`` takes a
port model's parameters back to that tree.  ``train_state_from_arrays``
and ``train_state_arrays`` carry a training state (step, f32 master
parameters, moments; the same trees) across both ways.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Mapping

import numpy as np
import torch

from .core.cotm import CoTMParams
from .device import resolve_device
from .impact.pipeline import IMPACTConfig, IMPACTSystem

if TYPE_CHECKING:
    from .models.config import ModelConfig

#: Array fields of an ``IMPACTSystem`` and their dtypes.
SYSTEM_ARRAYS = {"clause_g": torch.float32, "nonempty": torch.bool,
                 "class_g": torch.float32, "clause_i": torch.float32,
                 "class_i": torch.float32}


def params_from_arrays(ta_state, weights, *,
                       device: str | torch.device | None = None,
                       ) -> CoTMParams:
    """(K, n) TA states and (m, n) signed weights -> ``CoTMParams`` of
    int32 tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return CoTMParams(
        ta_state=torch.as_tensor(np.array(ta_state, np.int32), device=dev),
        weights=torch.as_tensor(np.array(weights, np.int32), device=dev))


def system_from_arrays(d: Mapping[str, Any], *,
                       device: str | torch.device | None = None,
                       ) -> IMPACTSystem:
    """Build the port's ``IMPACTSystem`` from array fields.

    ``d`` holds ``clause_g`` (R, C, tr, tc), ``nonempty`` (C*tc,),
    ``class_g`` (S, sr, m), ``clause_i``, ``class_i``, the ints
    ``n_literals`` / ``n_clauses`` / ``n_classes``, the floats
    ``program_energy_j`` / ``erase_energy_j``, and optionally ``cfg``, a
    mapping of ``IMPACTConfig`` fields, and the class tile's encoding map
    ``weight_shift`` / ``w_max`` (``encode_stats["weight_shift"]`` and
    ``encode_stats["weights"]["w_max"]``, which ``train.OnlineTrainer``
    reads).  The currents are taken as given, not recomputed from the
    conductances.
    """
    dev = resolve_device(device)
    arrays = {k: torch.as_tensor(np.array(d[k]), device=dev).to(dt)
              .contiguous() for k, dt in SYSTEM_ARRAYS.items()}
    stats = dict(program_energy_j=float(d["program_energy_j"]),
                 erase_energy_j=float(d["erase_energy_j"]))
    if "weight_shift" in d:
        stats["weight_shift"] = int(d["weight_shift"])
    if "w_max" in d:
        stats["weights"] = dict(w_max=int(d["w_max"]))
    return IMPACTSystem(
        **arrays,
        n_literals=int(d["n_literals"]), n_clauses=int(d["n_clauses"]),
        n_classes=int(d["n_classes"]),
        cfg=IMPACTConfig(**dict(d.get("cfg", {}))), encode_stats=stats)


def _tensor(a) -> torch.Tensor:
    """An array as a tensor of its dtype (a copy); numpy's ``bfloat16``
    extension dtype, as jax hands bf16 arrays over, becomes
    ``torch.bfloat16`` bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def lm_params_from_arrays(cfg: ModelConfig, tree: Mapping[str, Any], *,
                          device: str | torch.device | None = None):
    """The port's model of ``cfg`` (``models.build``: any of the ten
    architectures) on ``device`` (default ``cuda``) with its parameters
    copied from ``tree``, the reference's parameter tree as arrays: the
    leading ``"layers"`` axis is unstacked into the layer list, every
    other leaf (zamba2's ``"shared_attn"`` among them) and layout is kept,
    so each leaf is a copy.  Its ``state_dict()`` is the state dict of the
    same values.  Raises unless every leaf of the declarations is given,
    at its shape (``StackedLM.load_tree``)."""
    from .models import build
    from .models.base import tree_map
    return build(cfg, device=device).load_tree(tree_map(_tensor, dict(tree)))


def lm_arrays(model) -> dict:
    """The inverse of ``lm_params_from_arrays``: a port model's parameters
    as the reference's tree of f32 numpy arrays, ``"layers"`` stacked."""
    from .models.base import tree_map
    return tree_map(lambda t: t.cpu().float().numpy(), model.tree())


def train_state_from_arrays(state, *,
                            device: str | torch.device | None = None):
    """A training state given as arrays (an object with ``step``,
    ``params``, ``m``, ``v``, such as the reference's ``TrainState`` with
    numpy leaves, or a mapping of those keys; the trees in the reference's
    layout, ``"layers"`` stacked) -> ``train.TrainState`` of tensors on
    ``device`` (default ``cuda``), each leaf a copy at its dtype (bf16
    moments stay bf16)."""
    from .models.base import tree_map
    from .train.optimizer import TrainState
    dev = resolve_device(device)
    get = (state.__getitem__ if isinstance(state, Mapping)
           else lambda k: getattr(state, k))
    put = lambda a: _tensor(a).to(dev)
    return TrainState(step=put(get("step")), **{
        k: tree_map(put, get(k)) for k in ("params", "m", "v")})


def train_state_arrays(state) -> dict:
    """The inverse of ``train_state_from_arrays``: {"step", "params", "m",
    "v"} as numpy arrays in the reference's layout; bf16 leaves come back
    widened to f32 (exact: numpy has no bf16 of its own)."""
    from .models.base import tree_map

    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return {"step": host(state.step), **{
        k: tree_map(host, getattr(state, k)) for k in ("params", "m", "v")}}

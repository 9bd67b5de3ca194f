"""Carry a model and a programmed system across from arrays.

Both functions take plain numpy arrays (or anything ``np.asarray``
accepts), so a system programmed elsewhere, such as by the JAX reference
package, crosses into the port without the port importing it:

    d = dict(clause_g=np.asarray(sys.clause_g), ..., n_literals=...,
             program_energy_j=..., erase_energy_j=...)
    system = system_from_arrays(d, device="cuda")
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.cotm import CoTMParams
from .device import resolve_device
from .impact.pipeline import IMPACTConfig, IMPACTSystem

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
        ta_state=torch.as_tensor(np.asarray(ta_state, np.int32), device=dev),
        weights=torch.as_tensor(np.asarray(weights, np.int32), device=dev))


def system_from_arrays(d: Mapping[str, Any], *,
                       device: str | torch.device | None = None,
                       ) -> IMPACTSystem:
    """Build the port's ``IMPACTSystem`` from array fields.

    ``d`` holds ``clause_g`` (R, C, tr, tc), ``nonempty`` (C*tc,),
    ``class_g`` (S, sr, m), ``clause_i``, ``class_i``, the ints
    ``n_literals`` / ``n_clauses`` / ``n_classes``, the floats
    ``program_energy_j`` / ``erase_energy_j``, and optionally ``cfg``, a
    mapping of ``IMPACTConfig`` fields.  The currents are taken as given,
    not recomputed from the conductances.
    """
    dev = resolve_device(device)
    arrays = {k: torch.as_tensor(np.array(d[k]), device=dev).to(dt)
              .contiguous() for k, dt in SYSTEM_ARRAYS.items()}
    return IMPACTSystem(
        **arrays,
        n_literals=int(d["n_literals"]), n_clauses=int(d["n_clauses"]),
        n_classes=int(d["n_classes"]),
        cfg=IMPACTConfig(**dict(d.get("cfg", {}))),
        encode_stats=dict(program_energy_j=float(d["program_energy_j"]),
                          erase_energy_j=float(d["erase_energy_j"])))

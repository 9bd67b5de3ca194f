"""Logical-axis -> mesh-axis rule tables (the port of
``repro.sharding.rules``, table for table).

One table serves every architecture of the LM stack, which applies the
rules with divisibility fallbacks per tensor (``"experts"`` -> ``"model"``
only when the expert count divides the model axis; otherwise the expert
hidden dim picks up ``"model"``).  ``models.base.ShardCtx`` applies
them; the ZeRO train step reads the first two (parameters, moments and
gradients) and ``act_rules``' batch entry.

* ``param_rules`` — weights.  ``zero3=True`` also shards the d_model
  ("embed") dims over the data axes (ZeRO-3 / FSDP).
* ``opt_rules`` — optimizer moments: always ZeRO (sharded over data).
* ``act_rules`` — activations: batch over (pod, data), sequence over
  "model" at layer boundaries (sequence parallelism), heads / mlp /
  experts over "model" inside blocks.
* ``crossbar_rules`` — the IMPACT crossbar grid of Fig. 14, which
  ``sharding.crossbar`` lowers: the R literal row-shards and the S class
  row-shards ride "model" (the digital AND of partial clauses is the sum
  of per-rank violation counts, the per-shard ADC and digital add the sum
  of partial class currents), the batch rides the data axes.
* ``merged_rules`` — one table for params and activations alike.

The tables are plain dicts; ``_dp`` reads the mesh's axis names through
``launch.mesh.axis_sizes``, so a ``DeviceMesh`` and a dict-shaped mesh
both work.
"""
from __future__ import annotations

from typing import Any

from ..launch.mesh import axis_sizes

DP_SINGLE = ("data",)
DP_MULTI = ("pod", "data")


def _dp(mesh) -> tuple[str, ...]:
    return DP_MULTI if "pod" in axis_sizes(mesh) else DP_SINGLE


def param_rules(mesh, *, zero3: bool = False) -> dict[str, Any]:
    dp = _dp(mesh)
    return {
        "vocab": "model",
        "embed": dp if zero3 else None,
        "heads": "model",
        "kv": "model",
        "head_dim": "model",   # fallback when kv/heads don't divide model
        "mlp": "model",
        "experts": "model",
        "moe_mlp": "model",
        "layers": None,
        "batch": dp,
    }


def opt_rules(mesh) -> dict[str, Any]:
    """Optimizer state: always fully ZeRO-sharded over the data axes."""
    return param_rules(mesh, zero3=True)


def act_rules(mesh, *, seq_parallel: bool = True) -> dict[str, Any]:
    dp = _dp(mesh)
    return {
        "batch": dp,
        "seq": "model" if seq_parallel else None,
        "heads": "model",
        "kv": "model",
        "head_dim": "model",
        "mlp": "model",
        "experts": "model",
        "moe_mlp": "model",
        "vocab": "model",
    }


def crossbar_rules(mesh) -> dict[str, Any]:
    """Fig. 14 -> mesh axes for the IMPACT crossbar grid (read by
    ``sharding.crossbar``): the literal row-shard axis (R) and the class
    row-shard axis (S) both map onto "model", the batch onto the data
    axes like every activation."""
    return {
        "batch": _dp(mesh),
        "literal_shard": "model",
        "class_shard": "model",
    }


def merged_rules(mesh, *, zero3: bool = False,
                 seq_parallel: bool = True) -> dict[str, Any]:
    """One table for params and activations (the tag sets only overlap on
    compatible entries)."""
    rules = act_rules(mesh, seq_parallel=seq_parallel)
    rules.update({k: v for k, v in param_rules(mesh, zero3=zero3).items()
                  if k not in rules})
    return rules

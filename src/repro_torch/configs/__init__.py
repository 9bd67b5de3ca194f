"""Architecture registry: the 10 assigned configs (the port of
``repro.configs``; pure data, copied so the port imports nothing of the
reference).

``get_config(name)`` returns the exact published ModelConfig;
``cells(name)`` returns the assigned (shape -> applicable) map — long_500k
runs only for the sub-quadratic families (ssm / hybrid).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ModelConfig, ShapeSpec

ARCH_IDS = [
    "grok-1-314b",
    "deepseek-v2-lite-16b",
    "qwen2-vl-2b",
    "musicgen-large",
    "llama3-8b",
    "qwen3-8b",
    "gemma-7b",
    "starcoder2-3b",
    "rwkv6-7b",
    "zamba2-7b",
]

_MODULES = {a: a.replace("-", "_") for a in ARCH_IDS}

# long_500k needs sub-quadratic attention: run for ssm/hybrid only.
LONG_CONTEXT_ARCHS = {"rwkv6-7b", "zamba2-7b"}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def cells(name: str) -> dict[str, bool]:
    """shape name -> applicable? for this arch (40 assigned cells total:
    32 runnable + 8 recorded long_500k skips)."""
    return {shape: (shape != "long_500k" or name in LONG_CONTEXT_ARCHS)
            for shape in SHAPES}


def all_cells() -> list[tuple[str, str, bool]]:
    return [(arch, shape, ok)
            for arch in ARCH_IDS
            for shape, ok in cells(arch).items()]


__all__ = ["ARCH_IDS", "LONG_CONTEXT_ARCHS", "get_config", "cells",
           "all_cells", "SHAPES", "ShapeSpec"]

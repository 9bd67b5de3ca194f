"""Meshes over ``torch.distributed``, the launcher of a world of ranks,
the input specs and layouts, and the meta-device dry run (the port of
``repro.launch``; ``census`` is the counterpart of ``hlo``'s accounting).

``dryrun`` is not imported here: run it as ``python -m
repro_torch.launch.dryrun``.
"""
from .mesh import (axis_sizes, fake_world, make_crossbar_mesh,
                   make_debug_mesh, make_production_mesh, spawn)
from .specs import (decode_axes, decode_specs, prefill_axes, prefill_specs,
                    synth_tokens, train_batch_axes, train_batch_specs)

__all__ = ["axis_sizes", "make_crossbar_mesh", "make_debug_mesh",
           "make_production_mesh", "fake_world", "spawn", "synth_tokens",
           "train_batch_axes", "train_batch_specs", "prefill_specs",
           "decode_specs", "prefill_axes", "decode_axes"]

"""Meshes over ``torch.distributed``, the launcher of a world of ranks,
and the batch specs and layouts (the port of ``repro.launch``: ``mesh``
and part of ``specs``)."""
from .mesh import (axis_sizes, make_crossbar_mesh, make_debug_mesh,
                   spawn)
from .specs import (decode_axes, prefill_axes, synth_tokens,
                    train_batch_axes, train_batch_specs)

__all__ = ["axis_sizes", "make_crossbar_mesh", "make_debug_mesh", "spawn",
           "synth_tokens", "train_batch_axes", "train_batch_specs",
           "prefill_axes", "decode_axes"]

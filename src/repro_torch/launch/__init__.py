"""Meshes over ``torch.distributed``, the launcher of a world of ranks,
and the training batch specs (the port of ``repro.launch``: ``mesh`` and
the one-device part of ``specs``)."""
from .mesh import (axis_sizes, make_crossbar_mesh, make_debug_mesh,
                   spawn)
from .specs import synth_tokens, train_batch_axes, train_batch_specs

__all__ = ["axis_sizes", "make_crossbar_mesh", "make_debug_mesh", "spawn",
           "synth_tokens", "train_batch_axes", "train_batch_specs"]

"""Meshes over ``torch.distributed`` and the launcher of a world of ranks
(the port of ``repro.launch``; only ``mesh`` is ported)."""
from .mesh import (axis_sizes, make_crossbar_mesh, make_debug_mesh,
                   spawn)

__all__ = ["axis_sizes", "make_crossbar_mesh", "make_debug_mesh", "spawn"]

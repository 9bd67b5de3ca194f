"""Hand-written CUDA kernels for the IMPACT hot path, their plain PyTorch
versions and the backend registry.

* ``csrc/crossbar_mvm.cu``  — analog conductance MVM with read nonlinearity
* ``csrc/fused_impact.cu``  — fused analog path: cell currents + CSA +
  periphery, optionally metered
* ``crossbar_mvm.py`` / ``fused_impact.py`` — the wrappers (launch counts,
  operand checks, CPU tensors to the plain versions)
* ``_build.py``  — ``nvcc`` build into ``build/torch_kernels/`` + ``ctypes``
* ``backends.py`` — registry: ``"cuda"`` (kernels) and ``"torch"`` (plain)
* ``ref.py``      — the plain PyTorch versions
"""
from . import backends, ref
from ._build import build_all, launch_counts, reset_launch_counts
from .backends import available_backends, get_backend, register_backend
from .crossbar_mvm import crossbar_mvm
from .fused_impact import fused_impact, fused_impact_metered

__all__ = ["backends", "ref", "available_backends", "get_backend",
           "register_backend", "build_all", "launch_counts",
           "reset_launch_counts", "crossbar_mvm", "fused_impact",
           "fused_impact_metered"]

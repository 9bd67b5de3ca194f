"""Hand-written CUDA kernels for the IMPACT hot path, their plain PyTorch
versions and the backend registry.

* ``csrc/crossbar_mvm.cu``  — analog conductance MVM with read nonlinearity
* ``csrc/fused_impact.cu``  — fused analog path: cell currents (f32, or
  2-bit packed codes unpacked on chip) + CSA + periphery, optionally
  metered
* ``csrc/ta_feedback.cu``   — online-training Type I/II TA deltas
* ``csrc/digital_cotm.cu``  — digital CoTM: ``clause_eval``, ``class_sum``
  and both fused (``fused_cotm``)
* ``csrc/flash_mla.cu``     — causal flash attention for MLA prefill
  (TMA, ``wgmma``, the online softmax in registers)
* ``csrc/hopper_async.cuh`` — ``cp.async``, ``griddepcontrol`` and launch
  helpers
* ``csrc/bit_pack.cuh``     — packing 0/1 bytes into words along the
  strided axis (shared-memory tiles, a shuffle transpose) and the tensor
  cores' binary AND + popcount product, for ``ta_feedback.cu`` and the
  digital clause stage
* ``crossbar_mvm.py`` / ``fused_impact.py`` / ``ta_feedback.py`` /
  ``clause_eval.py`` / ``class_sum.py`` / ``fused_cotm.py`` — the wrappers
  (launch counts, operand checks, CPU tensors to the plain versions);
  ``flash_attention.py`` wraps ``flash_mla.cu`` beside its plain version
* ``_build.py``  — ``nvcc`` build into ``build/torch_kernels/`` + ``ctypes``
* ``ops.py``      — the public wrappers: ``impl=`` through the registry,
  and ``fused_impact(mesh=)`` to the sharded lowering
  (``sharding.crossbar``)
* ``backends.py`` — registry: ``"cuda"`` (kernels), ``"cuda-packed"``
  (packed kernels for every fused call; its sessions pack once),
  ``"cuda-metered"`` (the metered kernel for every fused call) and
  ``"torch"`` (plain)
* ``packing.py``  — the 2-bit ternary clause operand
* ``ref.py``      — the plain PyTorch versions
"""
from . import backends, ops, packing, ref
from ._build import build_all, launch_counts, reset_launch_counts
from .backends import (available_backends, get_backend, register_backend,
                       unregister_backend)
from .class_sum import class_sum
from .clause_eval import clause_eval
from .crossbar_mvm import crossbar_mvm
from .fused_cotm import fused_cotm
from .fused_impact import (fused_impact, fused_impact_metered,
                           fused_impact_packed, fused_impact_packed_metered)
from .ta_feedback import ta_feedback

__all__ = ["backends", "ops", "packing", "ref", "available_backends",
           "get_backend", "register_backend", "unregister_backend",
           "build_all", "launch_counts",
           "reset_launch_counts", "class_sum", "clause_eval", "crossbar_mvm",
           "fused_cotm", "fused_impact", "fused_impact_metered",
           "fused_impact_packed", "fused_impact_packed_metered",
           "ta_feedback"]

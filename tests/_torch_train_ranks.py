"""The rank program of ``tests/test_torch_int8_psum.py``.

``int8_main(rank, tmp)`` runs on every rank of a ``gloo`` world that
``repro_torch.launch.mesh.spawn`` starts on the CPU.  It reads the numpy
inputs (``inputs.npz``: one slice a rank on the leading axis) from
``tmp``, runs ``int8_psum`` and ``compressed_grad_allreduce`` (with its
error feedback over several steps) on its own slice, and writes what it
computed to ``rank<rank>.npz``.  This module imports neither JAX nor the
reference package, so a rank starts with the port alone.
"""
import os

import numpy as np
import torch

from repro_torch.train import compressed_grad_allreduce, int8_psum


def int8_main(rank: int, tmp: str) -> None:
    z = np.load(os.path.join(tmp, "inputs.npz"))
    t = lambda a: torch.from_numpy(np.array(a[rank]))
    out = {"psum": int8_psum(t(z["x"])).numpy(),
           "psum_ragged": int8_psum(t(z["ragged"])).numpy()}
    errors = {"a": torch.zeros(z["ga"].shape[2:]),
              "b": torch.zeros(z["gb"].shape[2:])}
    for i in range(z["ga"].shape[0]):
        grads = {"a": t(z["ga"][i]), "b": t(z["gb"][i])}
        total, errors = compressed_grad_allreduce(grads, errors)
        for k in ("a", "b"):
            out[f"tot_{k}_{i}"] = total[k].numpy()
            out[f"err_{k}_{i}"] = errors[k].numpy()
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)

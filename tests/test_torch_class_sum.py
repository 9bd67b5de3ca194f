"""``class_sum``'s contract, held on the CPU: an int8 x int32 product
summed in int32 (``src/repro/kernels/class_sum.py``).  The port's plain
version (``repro_torch.kernels.ref.class_sum_ref``) against the
reference's Pallas kernel, run through ``repro.kernels.ops.class_sum(...,
impl="pallas")`` in interpret mode (which pads for the kernel), and
against numpy, on signed int8 clauses (not only the 0/1 the paths pass),
past one 16-class pass of the CUDA kernel, at one clause, past one
512-clause weight stage, and at lane counts off every multiple of the
kernel's 8 lanes a block.  The clause load width the wrapper picks is
held here too; the CUDA kernel itself runs only on a card, where
``chip_smoke.py`` holds it against this plain version.

Tolerance: none.  Every output is an int32 count, compared exactly.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build, backends, ref

# The module (the package's ``class_sum`` is the function).
cs_mod = importlib.import_module("repro_torch.kernels.class_sum")

# (B, N, M): ragged B (not a multiple of 8), M past 16, one clause, N past
# 512 and off every multiple of 4.
SHAPES = [(5, 70, 4), (37, 300, 37), (9, 1, 10), (13, 1030, 17),
          (256, 500, 10)]


def _operands(B, N, M, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (B, N)).astype(np.int8),
            rng.integers(-20, 21, (N, M)).astype(np.int32))


@pytest.mark.parametrize("B,N,M", SHAPES)
def test_signed_clauses_match_pallas_and_numpy(B, N, M):
    cl, w = _operands(B, N, M, seed=B + N + M)
    got = ref.class_sum_ref(torch.from_numpy(cl), torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (B, M)
    want = cl.astype(np.int64) @ w.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.class_sum(jnp.asarray(cl),
                                               jnp.asarray(w),
                                               impl="pallas")))
    # The CPU route of the wrapper and the "cuda" backend: the plain
    # version, bit for bit, and no launch.
    before = _build.launch_counts()
    assert torch.equal(cs_mod.class_sum(torch.from_numpy(cl),
                                        torch.from_numpy(w)), got)
    assert torch.equal(backends.get_backend("cuda").class_sum(
        torch.from_numpy(cl), torch.from_numpy(w).to(torch.int64)), got)
    assert _build.launch_counts() == before


def test_bool_clauses_count_as_ones():
    rng = np.random.default_rng(7)
    fired = rng.random((11, 130)) < 0.4
    w = rng.integers(-20, 21, (130, 10)).astype(np.int32)
    got = cs_mod.class_sum(torch.from_numpy(fired), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), fired.astype(np.int64) @ w)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.class_sum(jnp.asarray(fired),
                                               jnp.asarray(w),
                                               impl="pallas")))


@pytest.mark.parametrize("B,N,M", [(0, 50, 10), (5, 50, 0), (7, 0, 10)])
def test_empty_axes(B, N, M):
    """No lane or no class gives an empty result; no clause gives
    zeros (the kernel's one launch writes them)."""
    cl, w = _operands(B, N, M)
    got = cs_mod.class_sum(torch.from_numpy(cl), torch.from_numpy(w))
    assert got.shape == (B, M) and got.dtype == torch.int32
    assert not got.any()


def _clauses(B, N, offset):
    buf = torch.zeros(B * N + 16, dtype=torch.int8)
    assert buf.data_ptr() % 16 == 0
    return buf[offset:offset + B * N].view(B, N)


@pytest.mark.parametrize("N,offset,width", [
    (500, 0, 4), (500, 1, 1), (500, 2, 1), (500, 4, 4), (70, 0, 1),
    (1, 0, 1), (1032, 8, 4), (0, 0, 4)])
def test_clause_width_follows_pointer_and_n(N, offset, width):
    assert cs_mod.clause_width(_clauses(3, N, offset)) == width

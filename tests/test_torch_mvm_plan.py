"""``crossbar_mvm``'s launch plan, computed on the host, and its plain
version at the two call shapes of a staged sweep.

The plan (``repro_torch.kernels.crossbar_mvm.plan``) picks the kernel's
path and splits the contraction; the CUDA side only checks it, so its
properties are held here on the CPU with the SM count as a parameter:
the splits cover K exactly once in chunks that are whole stages, the
narrow path is taken for N < 16 and only there, and the paper clause call
fills about one wave.  The plain version is held against the JAX
reference's oracle and its Pallas kernel in interpret mode at the class
call (128, 500, 10) and at one lane, rtol 1e-5 / atol 1e-12
(``tests/test_kernels.py``).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ref

# The module (the package re-exports its function under the same name).
mvm = importlib.import_module("repro_torch.kernels.crossbar_mvm")

SMS = (132, 114)          # H100 SXM, H100 PCIe
# (B, K, N): the staged sweep's calls at the paper layout (a full row
# shard too), one lane, the ragged calls of chip_smoke's kernel shapes,
# and edge cases (K = 0, a single stage, many lanes).
SHAPES = [(128, 1568, 512), (128, 2048, 512), (128, 500, 10),
          (1, 1568, 512), (37, 150, 90), (37, 16, 3), (8, 200, 512),
          (16, 32, 33), (4, 100, 10), (3, 0, 20), (5, 0, 7), (130, 1, 17),
          (1000, 300, 3), (4096, 1568, 512)]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,K,N", SHAPES)
def test_splits_cover_k_exactly_once(B, K, N, sms):
    p = mvm.plan(B, K, N, sms)
    if p.path == mvm.NARROW:
        assert p.splits == 1
        return
    assert p.chunk > 0 and p.chunk % mvm.STAGE_K == 0
    chunks = [range(s * p.chunk, min(K, (s + 1) * p.chunk))
              for s in range(p.splits)]
    rows = [k for c in chunks for k in c]
    assert rows == list(range(K))                 # in order, no overlap
    if K:
        assert all(len(c) > 0 for c in chunks)    # no empty split
    if p.splits > 1:                              # deep enough to pipeline
        assert p.chunk >= mvm.MIN_SPLIT_STAGES * mvm.STAGE_K


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("N", [1, 3, 10, 15, 16, 17, 33, 512])
def test_narrow_path_iff_fewer_than_16_columns(N, sms):
    for B, K in ((128, 500), (1, 1568), (37, 3)):
        p = mvm.plan(B, K, N, sms)
        assert (p.path == mvm.NARROW) == (N < 16)
        if p.path == mvm.NARROW:
            assert 1 <= p.lanes <= mvm.NARROW_MAX_LANES
            assert p.blocks == -(-B // p.lanes)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,K,N", [(128, 1568, 512), (128, 2048, 512)])
def test_clause_call_fills_about_one_wave(B, K, N, sms):
    """The clause call of a staged sweep: 16 output tiles, split so that
    the blocks fill between three quarters of a wave and a whole one."""
    p = mvm.plan(B, K, N, sms)
    wave = mvm.BLOCKS_PER_SM * sms
    tiles = -(-B // mvm.TILE_B) * -(-N // mvm.TILE_N)
    assert p.path == mvm.TILES and p.blocks == tiles * p.splits
    assert 0.75 * wave <= p.blocks <= wave


@pytest.mark.parametrize("sms", SMS)
def test_no_split_when_tiles_fill_the_card(sms):
    p = mvm.plan(4096, 1568, 512, sms)
    assert p.splits == 1 and p.chunk >= 1568


def test_narrow_class_call_has_a_block_per_lane_group():
    assert mvm.plan(128, 500, 10, 132) == mvm.Plan(mvm.NARROW, 1, 500, 1,
                                                   128)
    assert mvm.plan(128, 500, 10, 114).lanes == 1
    assert mvm.plan(300, 500, 10, 114).lanes == 2
    assert mvm.plan(4096, 500, 10, 132).lanes == mvm.NARROW_MAX_LANES


def test_plan_is_computed_once_per_shape():
    mvm.plan.cache_clear()
    a = mvm.plan(128, 1568, 512, 132)
    assert mvm.plan(128, 1568, 512, 132) is a
    assert mvm.plan.cache_info().hits == 1


def test_copy_widths_follow_pointer_and_row_stride():
    buf = torch.zeros(150 * 90 + 4 * 1568)
    d = buf[:4 * 1568].view(4, 1568)
    g = buf[4 * 1568:4 * 1568 + 4 * 512].view(4, 512)
    assert d.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    assert mvm.copy_widths(d, g) == (16, 16)
    off = buf[1:1 + 4 * 1568].view(4, 1568)         # one float past
    assert mvm.copy_widths(off, g) == (4, 16)
    ragged = buf[:37 * 150].view(37, 150)           # 600-byte rows
    assert mvm.copy_widths(ragged, buf[:150 * 90].view(150, 90)) == (4, 4)


@pytest.mark.parametrize("B,K,N", [(128, 500, 10), (1, 1568, 512),
                                   (1, 500, 10)])
def test_plain_version_matches_jax_at_the_call_shapes(B, K, N):
    rng = np.random.default_rng(7)
    drive = rng.random((B, K)).astype(np.float32)
    g = (10.0 ** rng.uniform(-9, -5.6, (K, N))).astype(np.float32)
    t = (torch.from_numpy(drive), torch.from_numpy(g))
    j = (jnp.asarray(drive), jnp.asarray(g))
    for kw in (dict(), dict(v_read=1.0, cutoff=0.0)):
        got = ref.crossbar_mvm_ref(*t, **kw).numpy()
        for want in (jref.crossbar_mvm_ref(*j, **kw),
                     jops.crossbar_mvm(*j, impl="pallas", **kw)):
            np.testing.assert_allclose(got.astype(np.float64),
                                       np.asarray(want, np.float64),
                                       rtol=1e-5, atol=1e-12)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """CPU tensors reach the plain version through the wrapper, with no
    plan, no library and no counted launch."""
    rng = np.random.default_rng(8)
    d = torch.from_numpy(rng.random((128, 500)).astype(np.float32))
    g = torch.from_numpy((10.0 ** rng.uniform(-9, -5.6, (500, 10)))
                         .astype(np.float32))
    before = mvm.KERNEL.launches
    assert torch.equal(mvm.crossbar_mvm(d, g), ref.crossbar_mvm_ref(d, g))
    assert mvm.KERNEL.launches == before

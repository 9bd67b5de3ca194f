"""The port's plain crossbar kernels (``repro_torch.kernels.ref``) and its
backends, held against the JAX reference on the same numpy inputs.

The JAX side runs as its own tests run it: the ``xla`` einsum oracles on
every layout, and the Pallas kernels in interpret mode on the small
layouts only (interpret mode is slow).  The CUDA kernels themselves run
only on a card; ``chip_smoke.py`` holds them against these plain versions
there.  Here, CPU tensors must route the ``"cuda"`` backend to the plain
versions with identical results.

Tolerances are the reference's own (``tests/test_fused_impact.py``):
CSA bits and argmax exact; scores rtol 1e-6; clause meters and staged
column currents rtol 1e-3 (reassociated f32 sums over up to R*tr*C*tc
terms); class meters rtol 1e-5; ``crossbar_mvm`` rtol 1e-5 / atol 1e-12
(``tests/test_kernels.py``).
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.impact.yflash import I_CSA_THRESHOLD, read_current
from repro_torch.kernels import _build, backends, ref
from repro_torch.kernels.crossbar_mvm import crossbar_mvm
from repro_torch.kernels.fused_impact import fused_impact

# (B, K, n, M, R, tr, C, tc, S, sr), as in tests/test_fused_impact.py; the
# paper layout at B=1.
SHARD_SHAPES = [
    (4, 100, 50, 10, 1, 128, 1, 64, 1, 64),
    (37, 300, 77, 3, 2, 150, 3, 30, 5, 16),       # R>1, S>1, ragged
    (8, 520, 500, 10, 3, 200, 2, 256, 1, 2048),   # class pad >> clause pad
    (1, 1568, 500, 10, 1, 2048, 1, 512, 1, 2048), # paper MNIST layout
    (16, 64, 33, 4, 2, 32, 3, 11, 4, 9),          # tiny ragged everything
]
SMALL = [SHARD_SHAPES[i] for i in (0, 1, 4)]
TH = I_CSA_THRESHOLD


def _make(B, K, n, M, R, tr, C, tc, S, sr, seed=0, density=0.05):
    """numpy inputs in the physical current regime (the reference's
    ``_make_system``): literals, clause currents, nonempty, class
    currents."""
    rng = np.random.default_rng(seed)
    lit = rng.random((B, K)) < 0.5
    include = rng.random((R * tr, C * tc)) < density
    include[K:, :] = False
    include[:, n:] = False
    g = np.where(include,
                 2.5e-6 * (1 + 0.05 * rng.standard_normal(include.shape)),
                 0.9e-9 * (1 + 0.05 * rng.standard_normal(include.shape)))
    clause_g = g.reshape(R, tr, C, tc).transpose(0, 2, 1, 3).astype(np.float32)
    nonempty = include[:, :C * tc].any(axis=0)
    wg = rng.uniform(1e-9, 2.5e-6, (S, sr, M))
    wg *= (np.arange(S * sr).reshape(S, sr, 1) < n)
    class_g = wg.astype(np.float32)
    ci = read_current(torch.from_numpy(np.ascontiguousarray(clause_g)))
    cls = read_current(torch.from_numpy(class_g))
    return lit, ci.numpy(), nonempty, cls.numpy()


def _both(lit, ci, ne, cls):
    t = (torch.from_numpy(lit), torch.from_numpy(ci), torch.from_numpy(ne),
         torch.from_numpy(cls))
    j = (jnp.asarray(lit), jnp.asarray(ci), jnp.asarray(ne),
         jnp.asarray(cls))
    return t, j


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("shape", SHARD_SHAPES)
def test_fused_refs_match_jax_oracle(shape):
    (t, j) = _both(*_make(*shape))
    got = ref.fused_impact_ref(*t, thresh=TH).numpy()
    want = np.asarray(jref.fused_impact_ref(*j, thresh=TH))
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    _close(got, want, 1e-6)

    g_sc, g_cl, g_cs = ref.fused_impact_metered_ref(*t, thresh=TH)
    w_sc, w_cl, w_cs = jref.fused_impact_metered_ref(*j, thresh=TH)
    np.testing.assert_array_equal(g_sc.numpy().argmax(-1),
                                  np.asarray(w_sc).argmax(-1))
    _close(g_sc, w_sc, 1e-6)
    _close(g_cl, w_cl, 1e-3)
    _close(g_cs, w_cs, 1e-5)


@pytest.mark.parametrize("shape", SHARD_SHAPES)
def test_stage_refs_match_jax_oracle(shape):
    (t, j) = _both(*_make(*shape, seed=1))
    f_t, i_t = ref.impact_clause_bits_ref(t[0], t[1], t[2], thresh=TH)
    f_j, i_j = jref.impact_clause_bits_ref(j[0], j[1], j[2], thresh=TH)
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    _close(i_t, i_j, 1e-3)
    s_t, c_t = ref.impact_class_scores_ref(f_t, t[3])
    s_j, c_j = jref.impact_class_scores_ref(f_j, j[3])
    _close(s_t, s_j, 1e-6)
    _close(c_t, c_j, 1e-6)


@pytest.mark.parametrize("B,K,N", [(8, 100, 30), (37, 300, 77),
                                   (1, 2048, 512)])
def test_crossbar_mvm_ref_matches_jax_oracle(B, K, N):
    rng = np.random.default_rng(1)
    drive = rng.random((B, K)).astype(np.float32)
    g = (10.0 ** rng.uniform(-9, -5.6, (K, N))).astype(np.float32)
    got = ref.crossbar_mvm_ref(torch.from_numpy(drive), torch.from_numpy(g))
    want = jref.crossbar_mvm_ref(jnp.asarray(drive), jnp.asarray(g))
    _close(got, want, 1e-5, 1e-12)
    # The staged path's call: no nonlinearity, unit read voltage.
    got = ref.crossbar_mvm_ref(torch.from_numpy(drive), torch.from_numpy(g),
                               v_read=1.0, cutoff=0.0)
    want = jref.crossbar_mvm_ref(jnp.asarray(drive), jnp.asarray(g),
                                 v_read=1.0, cutoff=0.0)
    _close(got, want, 1e-5, 1e-12)


@pytest.mark.parametrize("shape", SMALL)
def test_refs_match_pallas_interpret(shape):
    """The plain versions against the reference's Pallas kernels, run in
    interpret mode as the reference's own CPU tests run them."""
    (t, j) = _both(*_make(*shape, seed=2))
    want = np.asarray(jops.fused_impact(*j, thresh=TH, impl="pallas"))
    got = ref.fused_impact_ref(*t, thresh=TH).numpy()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    _close(got, want, 1e-6)
    w_sc, w_cl, w_cs = jops.fused_impact(*j, thresh=TH, meter=True,
                                         impl="pallas")
    g_sc, g_cl, g_cs = ref.fused_impact_metered_ref(*t, thresh=TH)
    _close(g_sc, w_sc, 1e-6)
    _close(g_cl, w_cl, 1e-3)
    _close(g_cs, w_cs, 1e-5)
    rng = np.random.default_rng(3)
    drive = rng.random((shape[0], shape[1])).astype(np.float32)
    g = (10.0 ** rng.uniform(-9, -5.6, (shape[1], shape[2]))
         ).astype(np.float32)
    _close(ref.crossbar_mvm_ref(torch.from_numpy(drive), torch.from_numpy(g)),
           jops.crossbar_mvm(jnp.asarray(drive), jnp.asarray(g),
                             impl="pallas"), 1e-5, 1e-12)


@pytest.mark.parametrize("shape", SHARD_SHAPES)
def test_cuda_backend_routes_cpu_tensors_to_plain(shape):
    """The ``"cuda"`` backend's operand plumbing (dtype casts, layouts) on
    CPU tensors reaches the plain versions: the fused primitives give the
    plain results bit for bit, the staged compositions (per-shard
    ``crossbar_mvm``) the whole-array oracle's bits and currents, and no
    kernel launch is counted."""
    (t, _) = _both(*_make(*shape, seed=4))
    cuda, plain = backends.get_backend("cuda"), backends.get_backend("torch")
    before = _build.launch_counts()
    assert torch.equal(cuda.fused_impact(*t, thresh=TH),
                       plain.fused_impact(*t, thresh=TH))
    want = ref.fused_impact_metered_ref(t[0].to(torch.int8), *t[1:],
                                        thresh=TH)
    for got, w in zip(cuda.fused_impact_metered(*t, thresh=TH), want):
        assert torch.equal(got, w)
    f_c, i_c = cuda.impact_clause_bits(*t[:3], thresh=TH)
    f_p, i_p = plain.impact_clause_bits(*t[:3], thresh=TH)
    assert torch.equal(f_c, f_p)
    _close(i_c, i_p, 1e-3)
    s_c, c_c = cuda.impact_class_scores(f_c, t[3])
    s_p, c_p = plain.impact_class_scores(f_p, t[3])
    _close(s_c, s_p, 1e-6)
    _close(c_c, c_p, 1e-6)
    # The default metered composition over the staged primitives agrees
    # with the fused oracle (the reference's Backend default).
    comp = backends.Backend.fused_impact_metered(cuda, *t, thresh=TH)
    _close(comp[0], want[0], 1e-6)
    _close(comp[1], want[1], 1e-3)
    _close(comp[2], want[2], 1e-5)
    assert _build.launch_counts() == before


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """A tensor that is not on the CPU never reaches the plain version:
    anything that is not a CUDA tensor raises instead of falling back."""
    d = torch.empty((2, 3), device="meta")
    g = torch.empty((3, 4), device="meta")
    with pytest.raises(ValueError):
        crossbar_mvm(d, g)
    with pytest.raises(ValueError):
        crossbar_mvm(torch.zeros(2, 3), g)
    lit = torch.empty((2, 3), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        fused_impact(lit, torch.empty((1, 1, 3, 4), device="meta"),
                               torch.empty((4,), dtype=torch.bool,
                                           device="meta"),
                               torch.empty((1, 4, 2), device="meta"),
                               thresh=TH)


def test_registry_contract():
    assert backends.available_backends() == ("cuda", "cuda-metered",
                                             "cuda-packed", "torch")
    for name in backends.available_backends():
        bk = backends.get_backend(name)
        assert bk.name == name
        for p in backends.REQUIRED_PRIMITIVES:
            assert callable(getattr(bk, p)), (name, p)
    assert backends.REQUIRED_PRIMITIVES == (
        "clause_eval", "class_sum", "fused_cotm", "crossbar_mvm",
        "fused_impact", "fused_impact_metered", "impact_clause_bits",
        "impact_class_scores", "ta_feedback", "pack_clause_operand",
        "fused_impact_packed", "fused_impact_packed_metered")
    assert not any("coresident" in p for b in backends.available_backends()
                   for p in dir(backends.get_backend(b)))
    with pytest.raises(ValueError):
        backends.get_backend("pallas")
    with pytest.raises(ValueError):
        backends.register_backend(backends.CudaBackend())
    with pytest.raises(ValueError):
        backends.register_backend(backends.CudaPackedBackend())

    class Broken(backends.Backend):
        name = "broken"
        crossbar_mvm = None

    with pytest.raises(TypeError):
        backends.register_backend(Broken())

    class NoPacked(backends.TorchBackend):
        name = "no-packed"
        fused_impact_packed = None

    with pytest.raises(TypeError, match="fused_impact_packed"):
        backends.register_backend(NoPacked())


def test_build_needs_nvcc_and_names_libraries_by_content(monkeypatch,
                                                         tmp_path):
    """Without ``nvcc`` the build raises (nothing is built at import); a
    library's name is a hash of its source and flags, so a changed flag
    set rebuilds."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    a = _build._target("fused_impact.cu")
    assert a.parent == _build.BUILD_DIR and a.suffix == ".so"
    assert a == _build._target("fused_impact.cu")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._target("fused_impact.cu") != a
    assert set(_build.SOURCES) == {p.name for p in _build.CSRC.glob("*.cu")}


def test_build_hash_covers_every_header(monkeypatch, tmp_path):
    """Every ``csrc/*.cuh`` is part of each library's hash: editing any
    header's text renames every library, so a stale one never loads."""
    assert set(_build.HEADERS) == {p.name for p in _build.CSRC.glob("*.cuh")}
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {s: _build._target(s) for s in _build.SOURCES}
    for h in _build.HEADERS:
        text = (csrc / h).read_bytes()
        (csrc / h).write_bytes(text + b"\n// edited\n")
        assert all(_build._target(s) != before[s] for s in _build.SOURCES)
        (csrc / h).write_bytes(text)
    assert {s: _build._target(s) for s in _build.SOURCES} == before

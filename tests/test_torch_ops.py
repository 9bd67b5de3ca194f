"""``repro_torch.kernels.ops`` against ``repro.kernels.ops`` on the same
numpy inputs, and ``IMPACTSystem.clause_bits`` / ``class_scores`` against
the reference system's accessors.

Every wrapper runs on the port's ``"torch"`` backend and on ``"cuda"``
with CPU tensors (the kernels' plain versions), against the reference's
``impl="xla"`` oracles and its Pallas kernels in interpret mode.
Tolerances are the reference's own (``tests/test_fused_impact.py``,
``tests/test_kernels.py``): clause bits, violation counts, integer
scores and argmax exact; analog scores rtol 1e-6; clause meters and
staged column currents rtol 1e-3 (reassociated f32 sums); class meters
and class currents rtol 1e-5; ``crossbar_mvm`` rtol 1e-5 / atol 1e-12.
A mesh without a usable plan runs the single-device backend, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.impact import IMPACTConfig as JConfig
from repro.impact.pipeline import IMPACTSystem as JSystem
from repro.kernels import ops as jops
from repro.kernels import packing as jpacking
from repro_torch.convert import system_from_arrays
from repro_torch.kernels import ops, packing
from repro_torch.impact.yflash import I_CSA_THRESHOLD as TH

from test_torch_kernels import _close
from test_torch_runtime import _arrays

# (B, K, n, M, R, tr, C, tc, S, sr): R > 1 and S > 1, ragged; tiny ragged
# everything.  (The reference compiles each call per shape, so the
# layouts are few; tests/test_torch_kernels.py sweeps more of them.)
SHAPES = [(37, 300, 77, 3, 2, 150, 3, 30, 5, 16),
          (16, 64, 33, 4, 2, 32, 3, 11, 4, 9)]
IMPLS = ["torch", "cuda"]
REF_IMPLS = ["xla", "pallas"]
RTOL_SCORES, RTOL_CLAUSE, RTOL_CLASS = 1e-6, 1e-3, 1e-5


class FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


@pytest.fixture(scope="module", params=range(len(SHAPES)),
                ids=lambda i: f"shape{i}")
def analog(request):
    d, lits, valid = _arrays(*SHAPES[request.param], seed=request.param)
    return d, lits


def _digital(B, K, N, M, seed):
    rng = np.random.default_rng(seed)
    lits = rng.random((B, K)) < 0.5
    include = rng.random((K, N)) < min(0.05, 3.0 / K)
    include[:, ::5] = False                 # some empty clauses
    weights = rng.integers(-20, 20, (N, M)).astype(np.int32)
    return lits, include, weights


DIGITAL = [(33, 130, 77, 10)]


@pytest.mark.parametrize("ref_impl", REF_IMPLS)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", DIGITAL)
def test_digital_wrappers_match_reference(shape, impl, ref_impl):
    """``clause_eval`` (fired and viol, with the ``include.any(0)``
    default and an explicit mask), ``class_sum`` and ``fused_cotm``:
    exact."""
    lits, include, weights = _digital(*shape, seed=shape[0])
    ne = include.any(0)
    ne_given = ne.copy()
    ne_given[1::3] = False
    for mode in ("fired", "viol"):
        for mask in (None, ne_given):
            got = ops.clause_eval(_t(lits), _t(include),
                                  None if mask is None else _t(mask),
                                  mode=mode, impl=impl)
            want = jops.clause_eval(jnp.asarray(lits), jnp.asarray(include),
                                    None if mask is None
                                    else jnp.asarray(mask),
                                    mode=mode, impl=ref_impl)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    clauses = np.asarray(jops.clause_eval(jnp.asarray(lits),
                                          jnp.asarray(include), impl="xla"))
    got = ops.class_sum(_t(clauses.astype(np.int8)), _t(weights), impl=impl)
    want = jops.class_sum(jnp.asarray(clauses.astype(np.int8)),
                          jnp.asarray(weights), impl=ref_impl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for mask in (None, ne_given):
        got = ops.fused_cotm(_t(lits), _t(include), _t(weights),
                             None if mask is None else _t(mask), impl=impl)
        want = jops.fused_cotm(jnp.asarray(lits), jnp.asarray(include),
                               jnp.asarray(weights),
                               None if mask is None else jnp.asarray(mask),
                               impl=ref_impl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ref_impl", REF_IMPLS)
@pytest.mark.parametrize("impl", IMPLS)
def test_crossbar_mvm_matches_reference(analog, impl, ref_impl):
    d, lits = analog
    drive = (1.0 - lits[:, :64]).astype(np.float32)
    g = d["clause_g"].reshape(-1, d["clause_g"].shape[-1])[:64]
    for kw in (dict(), dict(v_read=1.0, cutoff=0.0)):
        got = ops.crossbar_mvm(_t(drive), _t(g), impl=impl, **kw)
        want = jops.crossbar_mvm(jnp.asarray(drive), jnp.asarray(g),
                                 impl=ref_impl, **kw)
        _close(got.numpy(), np.asarray(want), 1e-5, 1e-12)


def _check_fused(got, want, meter):
    if not meter:
        got, want = (got,), (want,)
    g0, w0 = got[0].numpy(), np.asarray(want[0])
    np.testing.assert_array_equal(g0.argmax(-1), w0.argmax(-1))
    _close(g0, w0, RTOL_SCORES)
    if meter:
        _close(got[1].numpy(), np.asarray(want[1]), RTOL_CLAUSE)
        _close(got[2].numpy(), np.asarray(want[2]), RTOL_CLASS)


@pytest.mark.parametrize("meter", [False, True])
@pytest.mark.parametrize("ref_impl", REF_IMPLS)
@pytest.mark.parametrize("impl", IMPLS)
def test_fused_impact_matches_reference(analog, impl, ref_impl, meter):
    d, lits = analog
    t = (_t(lits), _t(d["clause_i"]), _t(d["nonempty"]), _t(d["class_i"]))
    j = (jnp.asarray(lits), jnp.asarray(d["clause_i"]),
         jnp.asarray(d["nonempty"]), jnp.asarray(d["class_i"]))
    got = ops.fused_impact(*t, thresh=TH, impl=impl, meter=meter)
    want = jops.fused_impact(*j, thresh=TH, impl=ref_impl, meter=meter)
    _check_fused(got, want, meter)


@pytest.mark.parametrize("meter", [False, True])
@pytest.mark.parametrize("ref_impl", ["xla", "pallas-packed"])
@pytest.mark.parametrize("impl", ["torch", "cuda", "cuda-packed"])
def test_fused_impact_packed_matches_reference(analog, impl, ref_impl,
                                               meter):
    """The packed operand: the port's codes equal the reference's, its
    levels to rtol 1e-5 (f64 against f32 means), and the packed wrappers
    give the reference's scores and meters."""
    d, lits = analog
    tr = d["clause_i"].shape[2]
    pk = packing.pack_clause_operand(_t(d["clause_i"]))
    jpk = jpacking.pack_clause_operand(jnp.asarray(d["clause_i"]))
    np.testing.assert_array_equal(pk.bits.numpy(), np.asarray(jpk.bits))
    _close(pk.levels.numpy(), np.asarray(jpk.levels), 1e-5)
    got = ops.fused_impact_packed(_t(lits), pk, _t(d["nonempty"]),
                                  _t(d["class_i"]), thresh=TH, tr=tr,
                                  impl=impl, meter=meter)
    want = jops.fused_impact_packed(jnp.asarray(lits), jpk,
                                    jnp.asarray(d["nonempty"]),
                                    jnp.asarray(d["class_i"]), thresh=TH,
                                    tr=tr, impl=ref_impl, meter=meter)
    _check_fused(got, want, meter)


@pytest.mark.parametrize("mesh", [FakeMesh(data=4, model=1),
                                  FakeMesh(data=8), FakeMesh(model=7)],
                         ids=["model1", "no-model", "model7"])
def test_mesh_without_a_plan_runs_the_single_device_backend(analog, mesh):
    """No plan on the mesh (a model axis of one, none, or one that divides
    neither R nor S): the single-device backend runs, bit for bit, and no
    collective is reached."""
    d, lits = analog
    t = (_t(lits), _t(d["clause_i"]), _t(d["nonempty"]), _t(d["class_i"]))
    for meter in (False, True):
        want = ops.fused_impact(*t, thresh=TH, meter=meter)
        got = ops.fused_impact(*t, thresh=TH, meter=meter, mesh=mesh)
        for g, w in zip(got if meter else (got,), want if meter else (want,)):
            assert torch.equal(g, w)
    pk = packing.pack_clause_operand(t[1])
    tr = d["clause_i"].shape[2]
    want = ops.fused_impact_packed(t[0], pk, t[2], t[3], thresh=TH, tr=tr)
    got = ops.fused_impact_packed(t[0], pk, t[2], t[3], thresh=TH, tr=tr,
                                  mesh=mesh)
    assert torch.equal(got, want)


def test_wrappers_check_the_nonempty_shape(analog):
    d, lits = analog
    bad = _t(d["nonempty"][:-1])
    with pytest.raises(ValueError, match="nonempty"):
        ops.fused_impact(_t(lits), _t(d["clause_i"]), bad, _t(d["class_i"]),
                         thresh=TH)
    pk = packing.pack_clause_operand(_t(d["clause_i"]))
    with pytest.raises(ValueError, match="nonempty"):
        ops.fused_impact_packed(_t(lits), pk, bad, _t(d["class_i"]),
                                thresh=TH, tr=d["clause_i"].shape[2])


def _systems(d):
    jsys = JSystem(
        clause_g=jnp.asarray(d["clause_g"]),
        nonempty=jnp.asarray(d["nonempty"]),
        class_g=jnp.asarray(d["class_g"]),
        clause_i=jnp.asarray(d["clause_i"]),
        class_i=jnp.asarray(d["class_i"]), n_literals=d["n_literals"],
        n_clauses=d["n_clauses"], n_classes=d["n_classes"], cfg=JConfig(),
        encode_stats=dict(program_energy_j=0.0, erase_energy_j=0.0))
    return jsys, system_from_arrays(d, device="cpu")


@pytest.mark.parametrize("ref_impl", REF_IMPLS)
@pytest.mark.parametrize("impl", IMPLS)
def test_stage_accessors_match_reference_system(analog, impl, ref_impl):
    """``clause_bits``: bits exact, shard column currents rtol 1e-3;
    ``class_scores`` on the same bits: scores rtol 1e-6, currents rtol
    1e-6 (``tests/test_fused_impact.py:75-88``)."""
    d, lits = analog
    jsys, tsys = _systems(d)
    f_t, i_t = tsys.clause_bits(lits, impl=impl)
    f_j, i_j = jsys.clause_bits(jnp.asarray(lits), impl=ref_impl)
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    _close(i_t.numpy(), np.asarray(i_j), RTOL_CLAUSE)
    assert f_t.any(), "no clause fires on these literals"
    s_t, c_t = tsys.class_scores(f_t, impl=impl)
    s_j, c_j = jsys.class_scores(f_j, impl=ref_impl)
    _close(s_t.numpy(), np.asarray(s_j), RTOL_SCORES)
    _close(c_t.numpy(), np.asarray(c_j), RTOL_SCORES)
    np.testing.assert_array_equal(s_t.numpy().argmax(-1),
                                  np.asarray(s_j).argmax(-1))

"""The port's digital CoTM kernels and TA feedback deltas, held against
the JAX reference on the same numpy inputs: the plain versions
(``repro_torch.kernels.ref``) against the reference's Pallas kernels run
in interpret mode (as its own CPU tests run them) and against the numpy
oracle (the port's copy in ``repro_torch.core.ref``), on ragged shapes.

The CUDA kernels themselves run only on a card, where ``chip_smoke.py``
holds them against these plain versions; here the wrappers and the
``"cuda"`` backend must route CPU tensors to the plain versions with
identical results and count no launch.

Tolerance: none.  Every output is an integer count or a Boolean, and
every comparison is exact equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import backends as jbackends
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import quickstart
from repro_torch.convert import system_from_arrays
from repro_torch.core import ref as npref
from repro_torch.impact import RuntimeSpec
from repro_torch.kernels import (_build, backends, class_sum, clause_eval,
                                 fused_cotm, ref, ta_feedback)

# (B, K, N, M): K off every multiple of 32 and 128, N and M ragged; then
# the CUDA clause stage's edges: 33 lanes (a lane past a 32-lane tile),
# two whole 32-column tiles, and K past one 2048-literal stage.
SHAPES = [(5, 70, 33, 4), (37, 300, 77, 3), (9, 130, 129, 10),
          (33, 520, 64, 5), (16, 2080, 40, 3)]
# (2B, K, n): 2B off every multiple of 32; then the CUDA kernel's edges:
# one whole 128-row pass, 2B one row past it (two passes), and a tile's
# worth of columns and literals plus one.
FEEDBACK_SHAPES = [(16, 70, 33), (42, 130, 129), (6, 33, 5),
                   (128, 96, 36), (130, 129, 33)]


def _digital(B, K, N, M, seed=0):
    """Literals, an include matrix with a few includes a clause (some
    clauses empty, some fire), nonempty and signed weights (N, M)."""
    rng = np.random.default_rng(seed)
    lit = rng.random((B, K)) < 0.8
    inc = rng.random((K, N)) < 2.0 / K
    inc[:, ::7] = False                   # empty clauses
    w = rng.integers(-20, 21, (N, M)).astype(np.int32)
    return lit, inc, inc.any(axis=0), w


def _feedback(B2, K, n, seed=0):
    rng = np.random.default_rng(seed)
    bits = lambda *s: rng.integers(0, 2, s).astype(bool)
    return (bits(B2, K).astype(np.int8), bits(B2, n), bits(B2, n),
            bits(B2, n), rng.integers(0, 2, (K, n)).astype(np.int32),
            rng.integers(0, 2, (K, n)).astype(np.int32), bits(K, n))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("shape", SHAPES)
def test_digital_refs_match_pallas_and_numpy(shape):
    lit, inc, ne, w = _digital(*shape)
    tl, ti, tn, tw = _t(lit, inc, ne, w)
    jl, ji, jn, jw = (jnp.asarray(a) for a in (lit, inc, ne, w))

    fired = ref.clause_eval_ref(tl, ti, tn)
    viol = ref.clause_viol_ref(tl, ti)
    assert fired.dtype == torch.bool and viol.dtype == torch.int32
    assert 0 < int(fired.sum()) < fired.numel()
    np.testing.assert_array_equal(
        fired.numpy(), np.asarray(jops.clause_eval(jl, ji, jn,
                                                   impl="pallas")))
    np.testing.assert_array_equal(
        viol.numpy(), np.asarray(jops.clause_eval(jl, ji, jn, mode="viol",
                                                  impl="pallas")))
    np.testing.assert_array_equal(fired.numpy(),
                                  npref.clause_outputs_ref(lit, inc))
    np.testing.assert_array_equal(viol.numpy(),
                                  npref.violation_counts_ref(lit, inc))
    # nonempty=None: no mask in the oracles, include.any(0) in the wrappers.
    np.testing.assert_array_equal(ref.clause_eval_ref(tl, ti).numpy(),
                                  np.asarray(jref.clause_eval_ref(jl, ji)))
    assert torch.equal(clause_eval(tl.to(torch.int8), ti), fired)

    scores = ref.class_sum_ref(fired, tw)
    np.testing.assert_array_equal(
        scores.numpy(), np.asarray(jops.class_sum(jnp.asarray(fired.numpy()),
                                                  jw, impl="pallas")))
    np.testing.assert_array_equal(scores.numpy(), npref.class_scores_ref(
        fired.numpy(), w.T))
    fused = ref.fused_cotm_ref(tl, ti, tw, tn)
    assert torch.equal(fused, scores) and fused.dtype == torch.int32
    np.testing.assert_array_equal(
        fused.numpy(), np.asarray(jops.fused_cotm(jl, ji, jw, jn,
                                                  impl="pallas")))
    np.testing.assert_array_equal(fused.argmax(-1).numpy(),
                                  npref.predict_ref(lit, inc, w.T))
    assert torch.equal(fused_cotm(tl.to(torch.int8), ti, tw), fused)


@pytest.mark.parametrize("shape", FEEDBACK_SHAPES)
def test_ta_feedback_ref_matches_pallas(shape):
    ops = _feedback(*shape)
    got = ref.ta_feedback_ref(*_t(*ops))
    assert got.dtype == torch.int32 and int(got.abs().sum()) > 0
    j = tuple(jnp.asarray(a) for a in ops)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.ta_feedback_ref(*j)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbackends.get_backend("pallas").ta_feedback(
            *j, interpret=True)))


@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_backend_routes_cpu_tensors_to_plain(shape):
    """The ``"cuda"`` backend's casts and layouts on CPU tensors (bool
    literals, int64 weights) reach the plain versions, bit for bit, and
    count no kernel launch."""
    lit, inc, ne, w = _t(*_digital(*shape, seed=1))
    cuda, plain = backends.get_backend("cuda"), backends.get_backend("torch")
    before = _build.launch_counts()
    w64 = w.to(torch.int64)
    for mode in ("fired", "viol"):
        assert torch.equal(cuda.clause_eval(lit, inc, ne, mode=mode),
                           plain.clause_eval(lit, inc, ne, mode=mode))
    fired = plain.clause_eval(lit, inc, ne)
    assert torch.equal(cuda.class_sum(fired, w64),
                       plain.class_sum(fired, w))
    assert torch.equal(cuda.fused_cotm(lit, inc, ne, w64),
                       plain.fused_cotm(lit, inc, ne, w))
    fb = _t(*_feedback(2 * shape[0], shape[1], shape[2], seed=2))
    assert torch.equal(cuda.ta_feedback(*fb), plain.ta_feedback(*fb))
    assert torch.equal(backends.Backend.ta_feedback(cuda, *fb),
                       ref.ta_feedback_ref(*fb))
    assert torch.equal(class_sum(fired, w), plain.class_sum(fired, w))
    assert torch.equal(ta_feedback(*fb), ref.ta_feedback_ref(*fb))
    assert _build.launch_counts() == before


def test_wrappers_refuse_non_cpu_tensors_and_bad_modes():
    meta = lambda *s, dt=torch.int8: torch.empty(s, dtype=dt, device="meta")
    with pytest.raises(ValueError):
        clause_eval(meta(2, 3), meta(3, 4, dt=torch.bool),
                    meta(4, dt=torch.bool))
    with pytest.raises(ValueError):
        clause_eval(torch.zeros(2, 3, dtype=torch.int8),
                    meta(3, 4, dt=torch.bool), meta(4, dt=torch.bool))
    with pytest.raises(ValueError):
        class_sum(meta(2, 3), meta(3, 4, dt=torch.int32))
    with pytest.raises(ValueError):
        fused_cotm(meta(2, 3), meta(3, 4, dt=torch.bool),
                   meta(4, 5, dt=torch.int32), meta(4, dt=torch.bool))
    with pytest.raises(ValueError):
        ta_feedback(meta(4, 3), *(meta(4, 5, dt=torch.bool),) * 3,
                    *(meta(3, 5, dt=torch.int32),) * 2,
                    meta(3, 5, dt=torch.bool))
    with pytest.raises(ValueError, match="mode"):
        clause_eval(torch.zeros(2, 3, dtype=torch.int8),
                    torch.zeros(3, 4, dtype=torch.bool), mode="counts")
    symbols = set(_build.launch_counts())
    assert {"ta_feedback_i32", "clause_eval_i8", "class_sum_i32",
            "fused_cotm_i32"} <= symbols
    for p in backends.REQUIRED_PRIMITIVES:
        assert callable(getattr(backends.get_backend("cuda"), p))


def test_session_ta_feedback_entry():
    """``InferenceSession.ta_feedback`` runs the backend's primitive and
    is prepared once per doubled batch, like every entry."""
    rng = np.random.default_rng(4)
    K, n = 70, 33
    d = dict(clause_g=rng.random((1, 1, 128, 64)).astype(np.float32),
             nonempty=np.ones(64, bool),
             class_g=rng.random((1, 64, 4)).astype(np.float32),
             n_literals=K, n_clauses=n, n_classes=4, program_energy_j=0.0,
             erase_energy_j=0.0)
    d["clause_i"], d["class_i"] = d["clause_g"], d["class_g"]
    sess = system_from_arrays(d, device="cpu").compile(
        RuntimeSpec(device="cpu"))
    n0 = sess.trace_count
    ops = _feedback(16, K, n, seed=5)
    want = ref.ta_feedback_ref(*_t(*ops))
    for _ in range(2):
        assert torch.equal(sess.ta_feedback(*ops), want)
    assert sess.is_compiled("ta_feedback", 16)
    assert sess.trace_count == n0 + 1


def test_quickstart_runs_end_to_end_on_cpu():
    out = quickstart.main(["--device", "cpu", "--epochs", "1",
                           "--clauses", "20", "--train", "128", "--test",
                           "64"])
    assert out["kernels_consistent"] and out["kernel_agreement"] == 1.0
    assert out["report"].datapoints == 64
    assert 0.0 <= out["hw_acc"] <= 1.0 and out["report"].read_energy_j > 0

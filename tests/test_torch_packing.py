"""The port's 2-bit packed clause operand (``repro_torch.kernels.packing``),
its packed plain versions and backends, and ``RuntimeSpec(packing=
"2bit")`` sessions, held against the JAX reference on the same numpy
inputs.

The JAX side runs as its own tests run it: the packed einsum oracles
(``ref.*_packed_ref``), the ``"xla"`` session with ``packing="2bit"``,
and the Pallas packed kernels in interpret mode on the small layouts.
The CUDA packed kernels run only on a card; ``chip_smoke.py`` holds them
against these plain versions there.

Contracts: packed bits and ``population_split`` bit for bit;
``packed_nbytes`` and ``input_bytes`` exact.  The levels are the
population means, which the port sums in f64 and rounds to f32 once:
they equal the f64 mean of the reference's own codes, rounded once, bit
for bit.  The reference sums them in f32 in XLA's order, which at these
sizes (8,192 to 19,200 cells) lands up to 1.4e-6 relative off that
mean, so against the reference's levels the tests hold rtol 1e-5.  On
the same packed operand, scores rtol 1e-6 and argmax exact, clause
meters rtol 1e-3 and class meters rtol 1e-5 (the reference's
``tests/test_packing.py``).  Fused against staged meters of one packed session:
rtol 1e-4, invalid lanes exactly 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.impact import RuntimeSpec as JSpec
from repro.kernels import ops as jops
from repro.kernels import packing as jpacking
from repro.kernels import ref as jref
from repro_torch.impact import RuntimeSpec, runtime
from repro_torch.kernels import _build, backends, packing, ref
from repro_torch.kernels.fused_impact import (fused_impact_packed,
                                              fused_impact_packed_metered)
from test_torch_kernels import SHARD_SHAPES, SMALL, TH, _close, _make
from test_torch_runtime import pair  # noqa: F401  (the shared fixture)

BACKENDS = ["cuda", "cuda-packed", "torch"]
METERING = ["off", "staged", "fused"]


# -- pack / unpack -------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 2, 3, 5, 8, 130])
def test_pack_ternary_matches_jax_and_roundtrips(K):
    codes = np.random.default_rng(K).integers(0, 3, (K, 33)).astype(np.uint8)
    packed = packing.pack_ternary(torch.from_numpy(codes))
    assert packed.shape == (packing.packed_rows(K), 33)
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jpacking.pack_ternary(codes)))
    np.testing.assert_array_equal(
        packing.unpack_ternary(packed, K).numpy(), codes)


def test_bitfield_layout_contract():
    """Bit-field j of packed row q is cell row 4q+j; padding rows DEAD."""
    codes = torch.tensor([[1], [2], [0], [1], [2]], dtype=torch.uint8)
    packed = packing.pack_ternary(codes)
    assert packed.shape == (2, 1)
    assert int(packed[0, 0]) == (1 << 0) | (2 << 2) | (0 << 4) | (1 << 6)
    assert int(packed[1, 0]) == 2
    assert (packing.CODE_DEAD, packing.CODE_LCS, packing.CODE_HCS,
            packing.CELLS_PER_BYTE) == (jpacking.CODE_DEAD,
                                        jpacking.CODE_LCS,
                                        jpacking.CODE_HCS,
                                        jpacking.CELLS_PER_BYTE)


def test_population_split_and_levels_match_jax():
    """The split lands between the device populations, far-tail HCS cell
    below the CSA threshold included, and equals the reference's bit for
    bit; codes are the reference's; the levels are the exact means
    rounded once (the reference's within rtol 1e-5, see above), and
    dequantize as the reference's do."""
    rng = np.random.default_rng(0)
    hcs = 5e-6 * (1 + 0.05 * rng.standard_normal(200))
    hcs[0] = 4.0e-6
    lcs = 2.7e-9 * (1 + 0.05 * rng.standard_normal(200))
    cur = np.concatenate([hcs, lcs, [0.0]]).astype(np.float32)
    t, j = torch.from_numpy(cur), jnp.asarray(cur)
    split = packing.population_split(t)
    assert split.dtype == torch.float32
    assert float(split) == float(jpacking.population_split(j))
    assert lcs.max() < float(split) < hcs.min()
    codes = packing.classify_currents(t)
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jpacking.classify_currents(j)))
    assert (codes[:200] == packing.CODE_HCS).all()
    assert (codes[200:400] == packing.CODE_LCS).all()
    assert int(codes[400]) == packing.CODE_DEAD
    levels = packing.quant_levels(t, codes)
    np.testing.assert_array_equal(levels.numpy(),
                                  _exact_levels(cur, codes.numpy()))
    _close(levels, jpacking.quant_levels(j, jnp.asarray(codes.numpy())),
           1e-5)
    np.testing.assert_array_equal(
        packing.dequant_codes(codes, levels).numpy(),
        np.asarray(jpacking.dequant_codes(jnp.asarray(codes.numpy()),
                                          jnp.asarray(levels.numpy()))))
    # The reference's own example: two cells a population.
    few = torch.tensor([0.0, 2e-9, 4e-9, 5e-6, 7e-6])
    lv = packing.quant_levels(few, packing.classify_currents(few))
    _close(lv, [3e-9, 6e-6], 1e-6)
    _close(packing.dequant_codes(packing.classify_currents(few), lv),
           [0.0, 3e-9, 3e-9, 6e-6, 6e-6], 1e-6)
    flat = torch.full((4,), 5e-6)
    assert (packing.classify_currents(flat) == packing.CODE_HCS).all()


def _exact_levels(currents, codes):
    """``[i_lcs, i_hcs]``: each population's f64 mean, rounded once."""
    cur = np.asarray(currents, np.float64)
    return np.asarray([cur[codes == c].sum() / max((codes == c).sum(), 1)
                       for c in (packing.CODE_LCS, packing.CODE_HCS)],
                      np.float32)


@pytest.mark.parametrize("tr", [32, 33, 150])
def test_pack_clause_operand_matches_jax(tr):
    """An (R, C, tr, tc) operand packs 4:1 on the row axis into the
    reference's bits exactly, ragged tr % 4 included; it dequantizes back
    with every code preserved, ~16x smaller than the f32 currents."""
    _, ci, _, _ = _make(4, 100, 50, 10, 2, tr, 2, 32, 1, 64, seed=5)
    got = packing.pack_clause_operand(torch.from_numpy(ci))
    want = jpacking.pack_clause_operand(jnp.asarray(ci))
    assert got.bits.shape == (2, 2, packing.packed_rows(tr), 32)
    assert got.bits.dtype == torch.uint8
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
    assert float(packing.population_split(torch.from_numpy(ci))) == float(
        jpacking.population_split(jnp.asarray(ci)))
    np.testing.assert_array_equal(
        got.levels.numpy(),
        _exact_levels(ci, np.asarray(jpacking.classify_currents(
            jnp.asarray(ci)))))
    _close(got.levels, want.levels, 1e-5)
    assert packing.packed_nbytes(got) == jpacking.packed_nbytes(want)
    deq = packing.dequant_clause(got.bits, got.levels, tr)
    assert deq.shape == ci.shape and deq.dtype == torch.float32
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jpacking.dequant_clause(
            want.bits, jnp.asarray(got.levels.numpy()), tr)))
    np.testing.assert_array_equal(
        packing.classify_currents(deq).numpy(),
        packing.classify_currents(torch.from_numpy(ci)).numpy())
    assert packing.packed_nbytes(got) * 8 < ci.nbytes


# -- packed plain versions -----------------------------------------------------

def _packed_both(shape, seed):
    """Port and JAX operands of one system, with the clause operand packed
    by the reference (both sides then read the same codes and levels)."""
    lit, ci, ne, cls = _make(*shape, seed=seed)
    jp = jpacking.pack_clause_operand(jnp.asarray(ci))
    bits, levels = np.array(jp.bits), np.array(jp.levels)
    t = (torch.from_numpy(lit), torch.from_numpy(bits),
         torch.from_numpy(levels), torch.from_numpy(ne),
         torch.from_numpy(cls))
    j = (jnp.asarray(lit), jp, jnp.asarray(ne), jnp.asarray(cls))
    return t, j, ci


@pytest.mark.parametrize("shape", SHARD_SHAPES)
def test_packed_refs_match_jax_oracle(shape):
    t, (lit, jp, ne, cls), ci = _packed_both(shape, seed=31)
    tr = shape[5]
    got = ref.fused_impact_packed_ref(*t, thresh=TH, tr=tr)
    want = jref.fused_impact_packed_ref(lit, jp.bits, jp.levels, ne, cls,
                                        thresh=TH, tr=tr)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
    _close(got, want, 1e-6)
    # Quantization keeps every CSA decision: the unpacked argmax.
    unpacked = ref.fused_impact_ref(t[0], torch.from_numpy(ci), t[3], t[4],
                                    thresh=TH)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  unpacked.argmax(-1).numpy())
    g_sc, g_cl, g_cs = ref.fused_impact_packed_metered_ref(*t, thresh=TH,
                                                           tr=tr)
    w_sc, w_cl, w_cs = jref.fused_impact_packed_metered_ref(
        lit, jp.bits, jp.levels, ne, cls, thresh=TH, tr=tr)
    np.testing.assert_array_equal(g_sc.argmax(-1).numpy(),
                                  np.asarray(w_sc).argmax(-1))
    _close(g_sc, w_sc, 1e-6)
    _close(g_cl, w_cl, 1e-3)
    _close(g_cs, w_cs, 1e-5)


@pytest.mark.parametrize("shape", SMALL)
def test_packed_refs_match_pallas_interpret(shape):
    """The packed plain versions against the reference's packed Pallas
    kernels, run in interpret mode as its own CPU tests run them."""
    t, (lit, jp, ne, cls), _ = _packed_both(shape, seed=33)
    tr = shape[5]
    want = jops.fused_impact_packed(lit, jp, ne, cls, thresh=TH, tr=tr)
    got = ref.fused_impact_packed_ref(*t, thresh=TH, tr=tr)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
    _close(got, want, 1e-6)
    w_sc, w_cl, w_cs = jops.fused_impact_packed(lit, jp, ne, cls, thresh=TH,
                                                tr=tr, meter=True)
    g_sc, g_cl, g_cs = ref.fused_impact_packed_metered_ref(*t, thresh=TH,
                                                           tr=tr)
    _close(g_sc, w_sc, 1e-6)
    _close(g_cl, w_cl, 1e-3)
    _close(g_cs, w_cs, 1e-5)


@pytest.mark.parametrize("shape", SMALL)
def test_backends_route_packed_cpu_tensors_to_plain(shape):
    """On CPU tensors the ``"cuda"`` backend's packed primitives and the
    ``"cuda-packed"`` backend's fused primitives (pack, then the packed
    path) give the packed plain versions bit for bit, as does the
    ``"torch"`` backend (the dequantize-and-delegate default); the
    default on every backend gives them to rtol 1e-6; no kernel launch
    is counted."""
    lit, ci, ne, cls = (torch.from_numpy(a) for a in _make(*shape, seed=4))
    tr = shape[5]
    pk = packing.pack_clause_operand(ci)
    want = ref.fused_impact_packed_ref(lit, *pk, ne, cls, thresh=TH, tr=tr)
    want_m = ref.fused_impact_packed_metered_ref(lit, *pk, ne, cls,
                                                 thresh=TH, tr=tr)
    before = _build.launch_counts()
    for name in BACKENDS:
        bk = backends.get_backend(name)
        p2 = bk.pack_clause_operand(ci)
        assert torch.equal(p2.bits, pk.bits)
        assert torch.equal(p2.levels, pk.levels)
        assert torch.equal(
            bk.fused_impact_packed(lit, pk, ne, cls, thresh=TH, tr=tr), want)
        for got, w in zip(bk.fused_impact_packed_metered(
                lit, pk, ne, cls, thresh=TH, tr=tr), want_m):
            assert torch.equal(got, w)
        dflt = backends.Backend.fused_impact_packed(bk, lit, pk, ne, cls,
                                                    thresh=TH, tr=tr)
        np.testing.assert_array_equal(dflt.argmax(-1), want.argmax(-1))
        _close(dflt, want, 1e-6)
    cp = backends.get_backend("cuda-packed")
    assert torch.equal(cp.fused_impact(lit, ci, ne, cls, thresh=TH), want)
    for got, w in zip(cp.fused_impact_metered(lit, ci, ne, cls, thresh=TH),
                      want_m):
        assert torch.equal(got, w)
    assert _build.launch_counts() == before


def test_packed_wrappers_refuse_non_cpu_non_cuda_tensors():
    """A packed operand that is not on the CPU never reaches the plain
    version; a malformed one raises before any launch."""
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    args = (meta(2, 3, dt=torch.int8), meta(1, 1, 1, 4, dt=torch.uint8),
            meta(2), meta(4, dt=torch.bool), meta(1, 4, 2))
    for fn in (fused_impact_packed, fused_impact_packed_metered):
        with pytest.raises(ValueError):
            fn(*args, thresh=TH, tr=3)
        with pytest.raises(ValueError):
            fn(torch.zeros((2, 3), dtype=torch.int8), *args[1:], thresh=TH,
               tr=3)


# -- packed sessions -----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_packed(pair):
    """The reference's packed ``"xla"`` session results per metering mode."""
    jsys, _, lits, valid = pair
    out = {}
    for m in METERING:
        js = jsys.compile(JSpec(backend="xla", metering=m, packing="2bit"))
        out[m] = (js.predict(jnp.asarray(lits)),
                  js.infer_step(jnp.asarray(lits), jnp.asarray(valid)),
                  None if m == "off" else js.infer_with_report(
                      jnp.asarray(lits), valid=valid))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("metering", METERING)
def test_packed_session_matches_unpacked_and_jax(pair, jax_packed, backend,
                                                 metering):
    """``packing="2bit"`` predicts what the unpacked session predicts and
    what the reference's packed session predicts, with its scores, lane
    energies and report (the quantized currents) held to the reference's
    packed session."""
    _, tsys, lits, valid = pair
    w_pred, w_step, w_rep = jax_packed[metering]
    ts = tsys.compile(RuntimeSpec(backend=backend, metering=metering,
                                  packing="2bit", device="cpu"))
    assert "packing='2bit'" in repr(ts)
    plain = tsys.compile(RuntimeSpec(backend=backend, metering=metering,
                                     device="cpu"))
    got = ts.predict(lits)
    assert torch.equal(got.predictions, plain.predict(lits).predictions)
    np.testing.assert_array_equal(got.predictions.numpy(),
                                  np.asarray(w_pred.predictions))
    _close(got.scores, w_pred.scores, 1e-6)

    step = ts.infer_step(lits, valid)
    np.testing.assert_array_equal(step.predictions.numpy(),
                                  np.asarray(w_step.predictions))
    for lane_t, lane_j, rtol in ((step.e_clause_lanes,
                                  w_step.e_clause_lanes, 1e-3),
                                 (step.e_class_lanes, w_step.e_class_lanes,
                                  1e-5)):
        assert (lane_t.numpy()[~valid] == 0.0).all()
        _close(lane_t, lane_j, rtol)
    if metering == "off":
        return
    g_rep = ts.infer_with_report(lits, valid=valid)
    np.testing.assert_array_equal(g_rep.predictions.numpy(),
                                  np.asarray(w_rep.predictions))
    for f, rtol in (("clause_energy_j", 1e-3), ("class_energy_j", 1e-5)):
        np.testing.assert_allclose(getattr(g_rep.report, f),
                                   getattr(w_rep.report, f), rtol=rtol)
    assert g_rep.report.datapoints == w_rep.report.datapoints


def test_packed_input_bytes_match_jax(pair):
    """``input_bytes`` counts what the reference counts, packed and
    unpacked, for every entry; packing cuts the sweep's bytes 4x or
    more."""
    jsys, tsys, lits, _ = pair
    B = lits.shape[0]
    for packing_ in ("none", "2bit"):
        ts = tsys.compile(RuntimeSpec(packing=packing_, device="cpu"))
        js = jsys.compile(JSpec(backend="xla", packing=packing_))
        for entry in ("predict", "infer_step", "infer_with_report"):
            assert ts.input_bytes(entry, B) == js.input_bytes(entry, B), (
                packing_, entry)
    packed = tsys.compile(RuntimeSpec(packing="2bit", device="cpu"))
    unpacked = tsys.compile(RuntimeSpec(device="cpu"))
    assert (unpacked.input_bytes("infer_step", B)
            >= 4 * packed.input_bytes("infer_step", B))


@pytest.mark.parametrize("metering", METERING)
def test_cuda_packed_session_packs_once(pair, monkeypatch, metering):
    """A ``"cuda-packed"`` session holds the packed operand whatever its
    spec's ``packing``: it packs once when it is built and serves every
    sweep from that operand, as ``packing="2bit"`` on ``"cuda"`` does,
    with the same results and the same ``input_bytes``."""
    _, tsys, lits, valid = pair
    B = lits.shape[0]
    calls = []
    real = packing.pack_clause_operand
    monkeypatch.setattr(packing, "pack_clause_operand",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    s = runtime.InferenceSession(tsys, RuntimeSpec(
        backend="cuda-packed", metering=metering, device="cpu"))
    assert s.packed and s._clause_i is None and len(calls) == 1
    want = runtime.InferenceSession(tsys, RuntimeSpec(
        metering=metering, packing="2bit", device="cpu"))
    calls.clear()
    for _ in range(2):
        got = s.infer_step(lits, valid)
        got_p = s.predict(lits)
    assert calls == []
    w = want.infer_step(lits, valid)
    for x, y in ((got.predictions, w.predictions),
                 (got.e_clause_lanes, w.e_clause_lanes),
                 (got.e_class_lanes, w.e_class_lanes),
                 (got_p.scores, want.predict(lits).scores)):
        assert torch.equal(x, y)
    for entry in ("predict", "infer_step", "infer_with_report"):
        assert s.input_bytes(entry, B) == want.input_bytes(entry, B)


def test_packed_fused_and_staged_meters_agree(pair):
    """The packed kernel's in-kernel meters and the staged compositions
    over the dequantized codes bill the same quantized currents; invalid
    lanes bill exactly 0."""
    _, tsys, lits, valid = pair
    fused = tsys.compile(RuntimeSpec(metering="fused", packing="2bit",
                                     device="cpu"))
    staged = tsys.compile(RuntimeSpec(metering="staged", packing="2bit",
                                      device="cpu"))
    a, b = fused.infer_step(lits, valid), staged.infer_step(lits, valid)
    assert torch.equal(a.predictions, b.predictions)
    for x, y in ((a.e_clause_lanes, b.e_clause_lanes),
                 (a.e_class_lanes, b.e_class_lanes)):
        assert (x[~torch.from_numpy(valid)] == 0.0).all()
        assert (y[~torch.from_numpy(valid)] == 0.0).all()
        np.testing.assert_allclose(x, y, rtol=1e-4)

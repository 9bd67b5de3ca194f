"""Device physics, energy accounting, tiles, the digital CoTM and the
programmed system of the port, held against the JAX reference on the same
numpy inputs.

Randomness is not shared between the two packages (``jax.random`` keys vs
``torch.Generator``), so parity runs on ideal devices
(``variability=False`` / ``c2c=False``: no draws at all); the noisy path
is held to its bands instead.

Exactness: the clause tile, ``read_current``, single pulses (against
the reference's compiled pulse, which fuses ``a + b * c`` into one
multiply-add as the port does), pulse counts and encode energies are
bit-identical.  The class tile's conductances are not bitwise: its 500 us
pre-tune decay factor ``exp(-500e-6 / 8.96e-4)`` rounds to one f32 ulp
apart in the two libraries (PyTorch's value is the correctly rounded
one).  Each pulse multiplies by that factor, and one ulp of a factor in
[0.5, 1) is at most 2**-23 relative, so after p pulses the two
trajectories differ by at most about p * 2**-23 relative; the tests hold
them to that bound, computed from the run's own pulse counts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cotm as jcotm
from repro.core.booleanize import booleanize as jbooleanize
from repro.core.booleanize import n_literals as jn_literals
from repro.data import synthetic as jsyn
from repro.impact import IMPACTConfig as JConfig
from repro.impact import RuntimeSpec as JSpec
from repro.impact import build_system as jbuild
from repro.impact import energy as jenergy
from repro.impact import tiles as jtiles
from repro.impact import yflash as jy
from repro_torch.convert import params_from_arrays, system_from_arrays
from repro_torch.core import cotm as tcotm
from repro_torch.core.booleanize import booleanize as tbooleanize
from repro_torch.core.booleanize import n_literals as tn_literals
from repro_torch.data import synthetic as tsyn
from repro_torch.impact import RuntimeSpec
from repro_torch.impact import energy as tenergy
from repro_torch.impact import pipeline as tpipe
from repro_torch.impact import tiles as ttiles
from repro_torch.impact import yflash as ty

CONSTANTS = ["G_LCS", "G_HCS_BOOL", "G_MIN", "G_MAX", "G_RANGE_LO",
             "G_RANGE_HI", "V_READ", "T_READ", "V_PROG", "V_ERASE",
             "TAU_PROG", "TAU_ERASE", "I_CSA_THRESHOLD", "LCS_NONLINEARITY",
             "G_NONLIN_CUTOFF", "C2C_SIGMA", "C2C_SIGMA_HCS", "D2D_SIGMA_TAU",
             "D2D_SIGMA_G"]
ENERGY_CONSTANTS = ["E_PROGRAM_PULSE", "E_ERASE_PULSE", "AREA_PER_DEVICE_UM2",
                    "T_COLUMN"]

# Small tiles so the build exercises R>1, C>1, S>1 shard grids.
K, N, M, N_STATES = 100, 40, 4, 64
TILES = dict(max_tile_rows=64, max_tile_cols=16, max_class_rows=32)


@pytest.mark.parametrize("name", CONSTANTS)
def test_yflash_constants_equal(name):
    assert getattr(ty, name) == getattr(jy, name)


@pytest.mark.parametrize("name", ENERGY_CONSTANTS)
def test_energy_constants_equal(name):
    assert getattr(tenergy, name) == getattr(jenergy, name)


def test_read_current_and_single_pulses_bitwise():
    rng = np.random.default_rng(0)
    g = (10.0 ** rng.uniform(-9.7, -5.4, 4096)).astype(np.float32)
    np.testing.assert_array_equal(
        ty.read_current(torch.from_numpy(g)).numpy(),
        np.asarray(jy.read_current(jnp.asarray(g))))
    vt, vj = ty.DeviceVariation.none(g.shape), jy.DeviceVariation.none(
        g.shape)
    for width in (1e-3, 50e-6):
        prog = jax.jit(lambda x: jy.program_pulse(x, width, vj))
        erase = jax.jit(lambda x: jy.erase_pulse(x, width, vj))
        np.testing.assert_array_equal(
            ty.program_pulse(torch.from_numpy(g), width, vt).numpy(),
            np.asarray(prog(jnp.asarray(g))))
        np.testing.assert_array_equal(
            ty.erase_pulse(torch.from_numpy(g), width, vt).numpy(),
            np.asarray(erase(jnp.asarray(g))))


@pytest.mark.parametrize("width,bitwise", [(1e-3, True), (500e-6, False)])
def test_pulse_until_ideal_matches_jax(width, bitwise):
    """The deterministic program/erase loop: identical pulse counts, and
    identical conductances except where the 500 us decay factor's f32 exp
    differs by one ulp between the libraries (module docstring)."""
    rng = np.random.default_rng(1)
    n = 3000
    g0 = (2.5e-6 * np.exp(0.05 * rng.standard_normal(n))).astype(np.float32)
    inc = rng.random(n) < 0.3
    lo = np.where(inc, 2.4e-6, 0.0).astype(np.float32)
    hi = np.where(inc, np.inf, 1e-9).astype(np.float32)
    g_j, p_j, e_j = jy.pulse_until(
        jnp.asarray(g0), target_lo=jnp.asarray(lo), target_hi=jnp.asarray(hi),
        width_prog=width, width_erase=width,
        var=jy.DeviceVariation.none((n,)), key=jax.random.key(0),
        max_pulses=64, c2c=False)
    g_t, p_t, e_t = ty.pulse_until(
        torch.from_numpy(g0), target_lo=torch.from_numpy(lo),
        target_hi=torch.from_numpy(hi), width_prog=width, width_erase=width,
        var=ty.DeviceVariation.none((n,)), generator=None, max_pulses=64,
        c2c=False)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    if bitwise:
        np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    else:
        pulses = int((p_t + e_t).max())
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j),
                                   rtol=pulses * 2.0 ** -23, atol=0)


def test_noisy_programming_lands_in_band():
    """With D2D and C2C noise from a seeded generator the encoders still
    drive every cell into its band, and the same seed reproduces the run."""
    rng = np.random.default_rng(2)
    include = torch.from_numpy(rng.random((64, 48)) < 0.1)
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        tile, stats = ttiles.encode_clause_tile(include, gen)
        runs.append(tile.g)
        assert stats["n_unconverged"] == 0
        assert bool((tile.g[include] >= ty.G_HCS_BOOL).all())
        assert bool((tile.g[~include] <= ty.G_LCS).all())
        assert 0 < int(stats["prog_pulses"].max()) <= 64
    assert torch.equal(runs[0], runs[1])
    w = torch.from_numpy(rng.integers(0, 30, (40, 4)))
    tile, stats = ttiles.encode_class_tile(w, torch.Generator().manual_seed(6))
    target = ttiles.weight_targets(w, int(w.max()))
    band = 5.0 * stats["segment_size"]
    assert stats["n_unconverged"] == int(
        ((tile.g - target).abs() > band).sum())
    assert stats["n_unconverged"] <= w.numel() // 20


def test_weight_targets_and_tiles_match_jax():
    rng = np.random.default_rng(3)
    w = rng.integers(0, 25, (40, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        ttiles.weight_targets(torch.from_numpy(w), 24).numpy(),
        np.asarray(jtiles.weight_targets(jnp.asarray(w), 24)))
    g = (10.0 ** rng.uniform(-9.5, -5.5, (64, 40))).astype(np.float32)
    ne = rng.random(40) < 0.9
    lits = rng.random((9, 64)) < 0.5
    t_tile = ttiles.ClauseTile(g=torch.from_numpy(g),
                               nonempty=torch.from_numpy(ne))
    j_tile = jtiles.ClauseTile(g=jnp.asarray(g), nonempty=jnp.asarray(ne))
    np.testing.assert_allclose(
        t_tile.currents(torch.from_numpy(lits)).numpy(),
        np.asarray(j_tile.currents(jnp.asarray(lits))), rtol=1e-5)
    np.testing.assert_array_equal(
        t_tile.clauses(torch.from_numpy(lits)).numpy(),
        np.asarray(j_tile.clauses(jnp.asarray(lits))))
    cg = (10.0 ** rng.uniform(-9, -5.6, (40, 4))).astype(np.float32)
    cl = rng.random((9, 40)) < 0.3
    np.testing.assert_array_equal(
        ttiles.ClassTile(g=torch.from_numpy(cg)).predict(
            torch.from_numpy(cl)).numpy(),
        np.asarray(jtiles.ClassTile(g=jnp.asarray(cg)).predict(
            jnp.asarray(cl))))


def test_digital_cotm_booleanize_and_data_match_jax():
    x, y = tsyn.digits(64, seed=3)
    xj, yj = jsyn.digits(64, seed=3)
    np.testing.assert_array_equal(x, xj)
    np.testing.assert_array_equal(y, yj)
    px, py = tsyn.prototype(32, n_classes=3, n_features=20, seed=1)
    np.testing.assert_array_equal(px, jsyn.prototype(32, n_classes=3,
                                                     n_features=20,
                                                     seed=1)[0])
    assert tsyn.TABLE5 == jsyn.TABLE5
    lit_t = tbooleanize(torch.from_numpy(x), n_bits=3)
    lit_j = jbooleanize(jnp.asarray(x), n_bits=3)
    np.testing.assert_array_equal(lit_t.numpy(), np.asarray(lit_j))
    assert tn_literals(784, 3) == jn_literals(784, 3)

    rng = np.random.default_rng(4)
    Kl = lit_t.shape[1]
    ta = np.where(rng.random((Kl, 30)) < 0.01, N_STATES + 1,
                  N_STATES).astype(np.int32)
    w = rng.integers(-9, 10, (10, 30)).astype(np.int32)
    cfg_t = tcotm.CoTMConfig(Kl, 30, 10, N_STATES)
    cfg_j = jcotm.CoTMConfig(Kl, 30, 10, N_STATES)
    p_t = params_from_arrays(ta, w, device="cpu")
    p_j = jcotm.CoTMParams(jnp.asarray(ta), jnp.asarray(w))
    c_t, s_t = tcotm.forward(p_t, lit_t, cfg_t)
    c_j, s_j = jcotm.forward(p_j, lit_j, cfg_j)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(
        tcotm.predict(p_t, lit_t, cfg_t).numpy(),
        np.asarray(jcotm.predict(p_j, lit_j, cfg_j)))
    np.testing.assert_array_equal(
        tcotm.violation_counts(lit_t, tcotm.include_mask(p_t.ta_state,
                                                         N_STATES)).numpy(),
        np.asarray(jcotm.violation_counts(lit_j, jcotm.include_mask(
            p_j.ta_state, N_STATES))))
    u_t, sh_t = tcotm.to_unipolar(p_t.weights)
    u_j, sh_j = jcotm.to_unipolar(p_j.weights)
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    assert int(sh_t) == int(sh_j)
    init = cfg_t.init(torch.Generator().manual_seed(0))
    assert set(np.unique(init.ta_state.numpy())) <= {N_STATES, N_STATES + 1}
    assert int(init.weights.abs().sum()) == 0


def _params(seed=0):
    rng = np.random.default_rng(seed)
    ta = np.where(rng.random((K, N)) < 0.05, N_STATES + 1,
                  N_STATES).astype(np.int32)
    w = rng.integers(-20, 20, (M, N)).astype(np.int32)
    return ta, w


@pytest.fixture(scope="module")
def ideal_pair():
    """The same CoTM built by both packages on ideal devices."""
    ta, w = _params()
    jsys = jbuild(jcotm.CoTMParams(jnp.asarray(ta), jnp.asarray(w)),
                  jcotm.CoTMConfig(K, N, M, N_STATES), jax.random.key(0),
                  JConfig(variability=False, finetune=True, **TILES))
    tsys = tpipe.build_system(
        params_from_arrays(ta, w, device="cpu"),
        tcotm.CoTMConfig(K, N, M, N_STATES), None,
        tpipe.IMPACTConfig(variability=False, finetune=True, **TILES),
        device="cpu")
    return jsys, tsys


def test_build_system_ideal_matches_jax(ideal_pair):
    jsys, tsys = ideal_pair
    for f in ("clause_g", "clause_i", "nonempty"):
        np.testing.assert_array_equal(getattr(tsys, f).numpy(),
                                      np.asarray(getattr(jsys, f)))
    wst = tsys.encode_stats["weights"]
    pulses = int(sum(wst[k].max() for k in (
        "pretune_prog", "pretune_erase", "finetune_prog", "finetune_erase")))
    for f in ("class_g", "class_i"):
        np.testing.assert_allclose(getattr(tsys, f).numpy(),
                                   np.asarray(getattr(jsys, f)),
                                   rtol=pulses * 2.0 ** -23, atol=0)
    assert tsys.clause_g.shape == (2, 3, 64, 16)
    assert tsys.class_g.shape == (2, 32, M)
    js, ts = jsys.encode_stats, tsys.encode_stats
    assert ts["program_energy_j"] == js["program_energy_j"]
    assert ts["erase_energy_j"] == js["erase_energy_j"]
    assert ts["weight_shift"] == js["weight_shift"]
    for k in ("pretune_prog", "pretune_erase", "finetune_prog",
              "finetune_erase"):
        np.testing.assert_array_equal(ts["weights"][k].numpy(),
                                      np.asarray(js["weights"][k]))
    for k in ("prog_pulses", "erase_pulses"):
        np.testing.assert_array_equal(ts["clause"][k].numpy(),
                                      np.asarray(js["clause"][k]))
    assert tsys._grid_latency() == jsys._grid_latency()
    assert tsys.area_mm2() == jsys.area_mm2()


def test_energy_accounting_matches_jax(ideal_pair):
    jsys, tsys = ideal_pair
    rng = np.random.default_rng(5)
    e_cl = rng.uniform(0, 1e-12, 16).astype(np.float32)
    e_cs = rng.uniform(0, 1e-13, 16).astype(np.float32)
    rt = tsys.step_report(torch.from_numpy(e_cl), torch.from_numpy(e_cs), 16)
    rj = jsys.step_report(jnp.asarray(e_cl), jnp.asarray(e_cs), 16)
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
    for prop in ("energy_per_datapoint_j", "gops", "tops_per_w",
                 "tops_per_mm2"):
        assert getattr(rt, prop) == getattr(rj, prop)
    i_cl = rng.uniform(0, 1e-4, 8).astype(np.float32)
    i_cs = rng.uniform(0, 1e-5, 8).astype(np.float32)
    for a, b in zip(tenergy.per_lane_read_energy(torch.from_numpy(i_cl),
                                                 torch.from_numpy(i_cs)),
                    jenergy.per_lane_read_energy(jnp.asarray(i_cl),
                                                 jnp.asarray(i_cs))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cur = rng.uniform(0, 1e-5, (4, 30)).astype(np.float32)
    np.testing.assert_allclose(
        tenergy.read_energy_from_currents(torch.from_numpy(cur)).numpy(),
        np.asarray(jenergy.read_energy_from_currents(jnp.asarray(cur))),
        rtol=1e-6)
    for args in ((500, 10, 1), (500, 10, 3), (37, 4, 8)):
        assert tenergy.inference_latency(*args) == \
            jenergy.inference_latency(*args)
    assert tenergy.tile_area_mm2(1568, 500) == jenergy.tile_area_mm2(1568,
                                                                     500)
    empty = tenergy.EnergyReport(0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0)
    assert empty.gops == 0.0 and empty.tops_per_w == 0.0
    with pytest.raises(ValueError):
        empty.tops_per_mm2


def test_system_from_arrays_round_trips_jax_system(ideal_pair):
    jsys, _ = ideal_pair
    d = {f: np.asarray(getattr(jsys, f)) for f in
         ("clause_g", "nonempty", "class_g", "clause_i", "class_i")}
    d.update(n_literals=jsys.n_literals, n_clauses=jsys.n_clauses,
             n_classes=jsys.n_classes,
             program_energy_j=jsys.encode_stats["program_energy_j"],
             erase_energy_j=jsys.encode_stats["erase_energy_j"],
             cfg=dataclasses.asdict(jsys.cfg))
    sys_ = system_from_arrays(d, device="cpu")
    for f in ("clause_g", "nonempty", "class_g", "clause_i", "class_i"):
        np.testing.assert_array_equal(getattr(sys_, f).numpy(), d[f])
    assert sys_.cfg == tpipe.IMPACTConfig(**dataclasses.asdict(jsys.cfg))
    lits = np.random.default_rng(6).random((12, K)) < 0.5
    np.testing.assert_array_equal(
        sys_.compile(RuntimeSpec(device="cpu")).predict(lits)
        .predictions.numpy(),
        np.asarray(jsys.compile(JSpec(backend="xla")).predict(
            jnp.asarray(lits)).predictions))


def test_noisy_build_system_is_seeded():
    """``variability=True``: the generator drives every draw, so one seed
    reproduces the programmed system; a different seed does not."""
    ta, w = _params(1)
    cfg = tcotm.CoTMConfig(K, N, M, N_STATES)
    ic = tpipe.IMPACTConfig(variability=True, finetune=True, **TILES)

    def build(seed):
        return tpipe.build_system(params_from_arrays(ta, w, device="cpu"),
                                  cfg, torch.Generator().manual_seed(seed),
                                  ic, device="cpu")

    a, b, c = build(0), build(0), build(1)
    assert torch.equal(a.clause_g, b.clause_g)
    assert torch.equal(a.class_g, b.class_g)
    assert not torch.equal(a.clause_g, c.clause_g)
    with pytest.raises(ValueError, match="Generator"):
        tpipe.build_system(params_from_arrays(ta, w, device="cpu"), cfg,
                           None, ic, device="cpu")
    # The adaptive programmer runs on ideal devices without a generator.
    _, stats = ttiles.encode_class_tile(
        torch.ones((4, 2), dtype=torch.int32), None, variability=False,
        adaptive=True)
    assert stats["adaptive"] and stats["n_unconverged"] == 0

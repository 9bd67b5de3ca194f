"""The port's closed-loop width-selecting programmer
(``repro_torch.impact.yflash.tune_adaptive``) and the ``adaptive=True``
branch of ``encode_class_tile`` against the JAX reference.

Contracts, on ideal devices (``c2c=False``, no draws):

* conductances at rtol 1e-6: XLA and PyTorch differ by one f32 ulp in
  ``exp`` on the CPU (ROADMAP Queue 3), so after p pulses a cell agrees
  to about p * 2**-23, not bitwise;
* program and erase counts equal, except where the reference's two best
  landing errors for that cell tie within 4 f32 ulps of its target (the
  same ``exp`` difference can then flip the choice of width); such cells
  are counted, and every differing cell must be one;
* ``encode_class_tile(adaptive=True)`` has the reference's stats keys and
  ``n_unconverged``.

On variable devices the draws come from a seeded ``torch.Generator``:
the same seed gives the same tile, and one widest erase step realizes
the HCS sigma (9.7 %), as the reference's own regression test pins.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.impact import tiles as jtiles
from repro.impact import yflash as jy
from repro_torch.impact import tiles as ttiles
from repro_torch.impact import yflash as ty

RTOL_G = 1e-6
TIE_ULPS = 4
FINE_TOL_SEGMENTS = 5.0
MAX_PULSES = 96


def _problem(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 300, shape).astype(np.int32)
    w_max = int(w.max())
    seg = (jy.G_RANGE_HI - jy.G_RANGE_LO) / w_max
    target = np.asarray(jtiles.weight_targets(jnp.asarray(w), w_max))
    return w, target, FINE_TOL_SEGMENTS * seg


def _reference(g0, target, tol):
    """The reference on ideal devices, with ``max_pulses`` traced so that
    one compile serves every prefix of the trajectory."""
    var = jy.DeviceVariation.none(g0.shape)
    fn = jax.jit(lambda g, p: jy.tune_adaptive(
        g, jnp.asarray(target), jnp.asarray(tol), var=var,
        key=jax.random.key(0), max_pulses=p, c2c=False))
    return lambda p: tuple(np.asarray(x) for x in fn(jnp.asarray(g0),
                                                     jnp.int32(p)))


def _port(g0, target, tol, p):
    var = ty.DeviceVariation.none(g0.shape)
    g, n_p, n_e = ty.tune_adaptive(torch.tensor(g0), torch.tensor(target),
                                   tol, var=var,
                                   generator=None, max_pulses=p, c2c=False)
    return g.numpy(), n_p.numpy(), n_e.numpy()


def _tied(ref, g0, target, tol, cells) -> np.ndarray:
    """For each differing cell (flat index), whether the reference's two
    best landing errors tie within ``TIE_ULPS`` f32 ulps of the cell's
    target at the first iteration where the two runs part."""
    flat_t = target.reshape(-1)
    tied = np.zeros(len(cells), bool)
    parted = np.full(len(cells), -1)
    for p in range(MAX_PULSES):
        a, b = ref(p + 1), _port(g0, target, tol, p + 1)
        differs = ((a[1] != b[1]) | (a[2] != b[2])).reshape(-1)[cells]
        parted = np.where((parted < 0) & differs, p, parted)
        if (parted >= 0).all():
            break
    var = jy.DeviceVariation.none(g0.shape)
    for i, (cell, p) in enumerate(zip(cells, parted)):
        g = jnp.asarray(ref(p)[0])
        land = np.stack([np.asarray(f(g, w, var)).reshape(-1)[cell]
                         for w in (500e-6, 50e-6, 5e-6)
                         for f in (jy.program_pulse, jy.erase_pulse)])
        e1, e2 = np.sort(np.abs(land - flat_t[cell]))[:2]
        tied[i] = e2 - e1 <= TIE_ULPS * np.spacing(np.float32(flat_t[cell]))
    return tied


@pytest.mark.parametrize("shape", [(48, 4), (500, 10)])
def test_tune_adaptive_matches_reference_on_ideal_devices(shape):
    w, target, tol = _problem(shape, seed=shape[0])
    g0 = np.full(shape, 2.5e-6, np.float32)
    ref = _reference(g0, target, tol)
    g_j, p_j, e_j = ref(MAX_PULSES)
    g_t, p_t, e_t = _port(g0, target, tol, MAX_PULSES)
    differing = np.flatnonzero(((p_j != p_t) | (e_j != e_t)).reshape(-1))
    tied = _tied(ref, g0, target, tol, differing)
    assert tied.all(), (f"{int((~tied).sum())} cells chose another width "
                        f"without a tie in the reference")
    same = np.ones(g_j.size, bool)
    same[differing] = False
    np.testing.assert_allclose(g_t.reshape(-1)[same], g_j.reshape(-1)[same],
                               rtol=RTOL_G)
    # The ideal programmer converges here, and pulses at all.
    assert int(p_j.sum() + e_j.sum()) > 0
    assert np.all(np.abs(g_t - target) <= tol * (1 + 1e-6))
    print(f"{shape}: {len(differing)} cells whose counts differ (tied)")


def test_encode_class_tile_adaptive_matches_reference_stats():
    w, target, tol = _problem((48, 4), seed=3)
    jt, js = jtiles.encode_class_tile(jnp.asarray(w), jax.random.key(0),
                                      variability=False, adaptive=True)
    tt, ts = ttiles.encode_class_tile(torch.as_tensor(w), None,
                                      variability=False, adaptive=True)
    assert set(ts) == set(js) == {"pretune_prog", "pretune_erase",
                                  "segment_size", "w_max", "adaptive",
                                  "n_unconverged"}
    assert ts["adaptive"] is True and ts["w_max"] == js["w_max"]
    assert ts["segment_size"] == pytest.approx(js["segment_size"], rel=1e-12)
    assert ts["n_unconverged"] == js["n_unconverged"] == 0
    np.testing.assert_array_equal(ts["pretune_prog"].numpy(),
                                  np.asarray(js["pretune_prog"]))
    np.testing.assert_array_equal(ts["pretune_erase"].numpy(),
                                  np.asarray(js["pretune_erase"]))
    np.testing.assert_allclose(tt.g.numpy(), np.asarray(jt.g), rtol=RTOL_G)
    # An impossible band under C2C noise leaves cells unconverged, and
    # the stats say so, as the reference's do.
    _, bad = ttiles.encode_class_tile(
        torch.as_tensor(w), torch.Generator().manual_seed(9), adaptive=True,
        finetune_tol_segments=1e-6, max_pulses=4)
    assert bad["n_unconverged"] > 0


def test_adaptive_draws_are_seeded():
    w = torch.as_tensor(_problem((32, 4), seed=5)[0])

    def encode(seed):
        return ttiles.encode_class_tile(
            w, torch.Generator().manual_seed(seed), adaptive=True)

    (a, sa), (b, sb), (c, _) = encode(1), encode(1), encode(2)
    assert torch.equal(a.g, b.g)
    assert torch.equal(sa["pretune_prog"], sb["pretune_prog"])
    assert not torch.equal(a.g, c.g)
    assert sa["n_unconverged"] == 0


def test_adaptive_draw_order_and_sigmas():
    """One iteration draws program noise, then erase noise, from the
    generator: replaying those two draws by hand gives the same cells.
    One widest erase step from a common start realizes the HCS sigma."""
    n = 8192
    g0 = torch.full((n,), 1e-7)
    target = torch.full((n,), ty.G_MAX * 0.9)
    var = ty.DeviceVariation.none((n,))
    g1, n_p, n_e = ty.tune_adaptive(g0, target, 1e-12, var=var,
                                    generator=torch.Generator().manual_seed(5),
                                    max_pulses=1)
    assert int(n_p.sum()) == 0 and int(n_e.sum()) == n
    gen = torch.Generator().manual_seed(5)
    torch.randn((n,), generator=gen)                     # program noise
    noise_e = torch.exp(ty.C2C_SIGMA_HCS * torch.randn((n,), generator=gen))
    rate = (1.0 - torch.exp(torch.full((n,), -500e-6) / ty.TAU_ERASE)) \
        * noise_e
    want = torch.addcmul(g0, ty.G_MAX - g0, torch.clamp(rate, 0.0, 1.0))
    assert torch.equal(g1, want)
    rate_det = 1.0 - np.exp(-500e-6 / ty.TAU_ERASE)
    realized = (g1.double().numpy() - 1e-7) / (ty.G_MAX - 1e-7)
    spread = float(np.std(np.log(realized / rate_det)))
    assert 0.085 <= spread <= 0.11, spread

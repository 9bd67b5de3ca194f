"""``repro_torch.numerics``: ``sqrt_rn`` / ``rsqrt_rn`` on CPU tensors
equal numpy's f64 result rounded once to f32, bit for bit.

PyTorch's own f32 ``sqrt`` / ``rsqrt`` on the CPU are not correctly
rounded on every host, which put the port one ulp off the reference
where it is held bit for bit (the 2-bit packing's population split,
AdamW's denominator) and moved the LM norms.  Held here: 1e6 seeded
draws over 120 binary decades and 1e6 over [0, 10), the population
split's operand of ``tests/test_torch_packing.py``, and the edges (zeros,
denormals, the largest finite value, infinity).  The card's lowering
(``torch.sqrt``, f64 for ``rsqrt``) is checked on the card by
``chip_smoke.py``'s build phase.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import packing as jpacking
from repro_torch.kernels import packing
from repro_torch.numerics import rsqrt_rn, sqrt_rn

from test_torch_packing import _make

DRAWS = 1_000_000


def _want_sqrt(x: np.ndarray) -> np.ndarray:
    return np.sqrt(x.astype(np.float64)).astype(np.float32)


def _want_rsqrt(x: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):
        return (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32)


FNS = [(sqrt_rn, _want_sqrt), (rsqrt_rn, _want_rsqrt)]
IDS = ["sqrt_rn", "rsqrt_rn"]


def _draws(spread: str) -> np.ndarray:
    rng = np.random.default_rng(0 if spread == "decades" else 1)
    if spread == "decades":
        return np.exp2(rng.uniform(-60.0, 60.0, DRAWS)).astype(np.float32)
    return rng.uniform(0.0, 10.0, DRAWS).astype(np.float32)


@pytest.mark.parametrize("spread", ["decades", "unit"])
@pytest.mark.parametrize("fn,want", FNS, ids=IDS)
def test_rounds_once_from_f64(fn, want, spread):
    x = _draws(spread)
    got = fn(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want(x))


def test_population_split_operand():
    """The f32 product whose root is the population split, as
    ``test_pack_clause_operand_matches_jax[32]`` builds it: the root
    rounded once, which is the split of the port and of the reference."""
    _, ci, _, _ = _make(4, 100, 50, 10, 2, 32, 2, 32, 1, 64, seed=5)
    cur = torch.from_numpy(ci)
    hi = torch.clamp(cur.max(), min=0.0)
    lo = torch.where(cur > 0.0, cur, hi).min()
    prod = torch.clamp(hi, min=1e-30) * torch.clamp(lo, min=1e-30)
    root = sqrt_rn(prod.reshape(1))
    np.testing.assert_array_equal(root.numpy(),
                                  _want_sqrt(prod.reshape(1).numpy()))
    assert float(packing.population_split(cur)) == float(root[0]) == float(
        jpacking.population_split(jnp.asarray(ci)))


EDGES = np.array([0.0, -0.0, 1e-45, 1.1754942e-38, 1.1754944e-38, 1.0,
                  3.4028235e38, np.inf], np.float32)


@pytest.mark.parametrize("fn,want", FNS, ids=IDS)
def test_zero_denormals_and_inf(fn, want):
    got = fn(torch.from_numpy(EDGES)).numpy()
    np.testing.assert_array_equal(got, want(EDGES))
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want(EDGES)))


@pytest.mark.parametrize("fn,want", FNS, ids=IDS)
def test_gradient_flows_in_f32(fn, want):
    """Autograd goes through the f64 leg and back to the input's dtype."""
    x = torch.tensor([0.25, 2.0, 9.0], requires_grad=True)
    fn(x).sum().backward()
    assert x.grad.dtype == torch.float32
    x64 = x.detach().double()
    slope = 0.5 / torch.sqrt(x64) if fn is sqrt_rn else -0.5 * x64 ** -1.5
    np.testing.assert_allclose(x.grad.numpy(), slope.numpy(), rtol=1e-7)

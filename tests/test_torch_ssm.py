"""The port's chunked linear-attention engine (``repro_torch.models.
ssm_common``) held against the reference's (``repro.models.ssm_common``)
and against ``tests/test_ssm.py``'s f64 sequential recurrence, on the same
numpy draws, on the CPU.

Tolerances: 2e-4 (rtol and atol) against the f64 recurrence and for the
port's own invariances (chunk size, step against parallel, continuation),
as the reference's test; 1e-5 against the reference's own f32 output on
the same inputs (the two sum the chunk algebra in other orders, and XLA's
``exp`` is one ulp off PyTorch's in about a tenth of the lanes) at chunks
of 16 or less, the configs' chunk.  At a chunk of 48 the exponents around
the mid-chunk normalizer reach 4 x 24 = 96 and the reference itself is
3.5e-5 off the f64 recurrence at these draws, so there the two are each
held to the recurrence instead.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm_common as jssm
from repro_torch.models import ssm_common as tssm
from test_ssm import _naive

TOL_NAIVE = 2e-4
TOL_REF = 1e-5


def _draws(seed, B=2, S=37, H=2, Dk=8, Dv=6):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, Dk)).astype(np.float32)
    k = rng.normal(size=(B, S, H, Dk)).astype(np.float32)
    v = rng.normal(size=(B, S, H, Dv)).astype(np.float32)
    lw = (-np.exp(rng.normal(size=(B, S, H, Dk)))).astype(np.float32)
    u = rng.normal(size=(H, Dk)).astype(np.float32)
    return q, k, v, lw, u


def _both(fn_name, arrays, **kw):
    """(port, reference) outputs of ``ssm_common.<fn_name>`` as numpy."""
    u = kw.pop("u", None)
    init = kw.pop("initial_state", None)
    tkw, jkw = dict(kw), dict(kw)
    if u is not None:
        tkw["u"], jkw["u"] = torch.from_numpy(u), jnp.asarray(u)
    if init is not None:
        tkw["initial_state"] = torch.from_numpy(init)
        jkw["initial_state"] = jnp.asarray(init)
    got = getattr(tssm, fn_name)(*map(torch.from_numpy, arrays), **tkw)
    want = getattr(jssm, fn_name)(*map(jnp.asarray, arrays), **jkw)
    return ([g.numpy() for g in got], [np.asarray(w) for w in want])


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_constants_equal_the_reference():
    assert tssm.LOG_W_MIN == jssm.LOG_W_MIN


@pytest.mark.parametrize("S", [1, 5, 16, 17, 37, 50])
@pytest.mark.parametrize("inclusive", [False, True])
def test_chunked_matches_reference_and_naive(inclusive, S):
    """Both masks; S below the chunk, on it and off it (the zero-padded
    tail)."""
    q, k, v, lw, u = _draws(S + 100 * inclusive, S=S)
    uu = None if inclusive else u
    (o, s), (jo, js) = _both("chunked_la", (q, k, v, lw), u=uu,
                             inclusive=inclusive, chunk=16)
    assert o.shape == (2, S, 2, 6) and s.shape == (2, 2, 8, 6)
    _close(o, _naive(q, k, v, lw, u=uu, inclusive=inclusive), TOL_NAIVE)
    _close(o, jo, TOL_REF)
    _close(s, js, TOL_REF)


@pytest.mark.parametrize("inclusive", [False, True])
def test_chunk_size_invariance(inclusive):
    q, k, v, lw, u = _draws(11, S=48)
    uu = None if inclusive else u
    outs = []
    want = _naive(q, k, v, lw, u=uu, inclusive=inclusive)
    for c in (4, 8, 16, 48):
        (o, s), (jo, js) = _both("chunked_la", (q, k, v, lw), u=uu,
                                 inclusive=inclusive, chunk=c)
        if c <= 16:
            _close(o, jo, TOL_REF)
            _close(s, js, TOL_REF)
        else:
            _close(o, want, TOL_NAIVE)
            _close(jo, want, TOL_NAIVE)
        outs.append((o, s))
    for o, s in outs[1:]:
        _close(o, outs[0][0], TOL_NAIVE)
        _close(s, outs[0][1], TOL_NAIVE)


@pytest.mark.parametrize("inclusive", [False, True])
def test_step_matches_parallel(inclusive):
    """``la_step`` token by token against ``chunked_la`` (the strict mask
    reads ``s + u kv`` before the update), and each step against the
    reference's ``la_step`` on the same state."""
    q, k, v, lw, u = _draws(7, S=32)
    uu = None if inclusive else u
    (o_par, s_par), _ = _both("chunked_la", (q, k, v, lw), u=uu,
                              inclusive=inclusive, chunk=8)
    state = np.zeros_like(s_par)
    outs = []
    for t in range(32):
        (ot, new), (jot, jnew) = _both(
            "la_step", (state, q[:, t], k[:, t], v[:, t], lw[:, t]), u=uu,
            inclusive=inclusive)
        _close(ot, jot, TOL_REF)
        _close(new, jnew, TOL_REF)
        outs.append(ot)
        state = new
    _close(np.stack(outs, 1), o_par, TOL_NAIVE)
    _close(state, s_par, TOL_NAIVE)


@pytest.mark.parametrize("inclusive", [False, True])
def test_initial_state_continuation(inclusive):
    """[first half] then [second half from the saved state] equals one
    full pass; the second half from a state equals the reference's."""
    q, k, v, lw, u = _draws(13, S=32)
    uu = None if inclusive else u
    (o_full, s_full), _ = _both("chunked_la", (q, k, v, lw), u=uu,
                                inclusive=inclusive, chunk=8)
    half = lambda a, sl: tuple(x[:, sl] for x in a)
    (o1, s1), _ = _both("chunked_la", half((q, k, v, lw), slice(0, 16)),
                        u=uu, inclusive=inclusive, chunk=8)
    (o2, s2), (jo2, js2) = _both(
        "chunked_la", half((q, k, v, lw), slice(16, 32)), u=uu,
        inclusive=inclusive, chunk=8, initial_state=s1)
    _close(np.concatenate([o1, o2], 1), o_full, TOL_NAIVE)
    _close(s2, s_full, TOL_NAIVE)
    _close(o2, jo2, TOL_REF)
    _close(s2, js2, TOL_REF)


@pytest.mark.parametrize("inclusive", [False, True])
def test_extreme_decay_stays_finite(inclusive):
    """log w = -100 (clamped to LOG_W_MIN): no inf or nan, and the
    reference's values."""
    q, k, v, _, u = _draws(0, B=1, S=64, H=1, Dk=4, Dv=4)
    lw = np.full(q.shape, -100.0, np.float32)
    uu = None if inclusive else u
    (o, s), (jo, js) = _both("chunked_la", (q, k, v, lw), u=uu,
                             inclusive=inclusive, chunk=16)
    assert np.isfinite(o).all() and np.isfinite(s).all()
    _close(o, jo, TOL_REF)
    _close(s, js, TOL_REF)
    _close(o, _naive(q, k, v, lw, u=uu, inclusive=inclusive), TOL_NAIVE)


def test_dtype_kept():
    """o comes back in q's dtype, the state in f32 (bf16 inputs)."""
    q, k, v, lw, u = (torch.from_numpy(a) for a in _draws(3, S=20))
    o, s = tssm.chunked_la(q.bfloat16(), k.bfloat16(), v.bfloat16(), lw,
                           u=u, chunk=16)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    o1, s1 = tssm.la_step(s, q[:, 0].bfloat16(), k[:, 0], v[:, 0],
                          lw[:, 0], u=u)
    assert o1.dtype == torch.bfloat16 and s1.dtype == torch.float32

"""The port's offline CoTM training (``repro_torch.core.train``) held
against the JAX reference (``repro.core.train``) on the same inputs and
the same random numbers.

The two packages cannot share a random stream, so the port takes its
draws as operands: the reference's ``jax.random.bernoulli(k, p, shape)``
is ``jax.random.uniform(k, shape) < p`` (its default ``mode="low"``),
and each test first asserts that identity for the keys it uses, then
hands the uniforms, drawn from the same split keys as the reference's
own (``core/train.py:68-69, 78, 99-101``), to the port.

Tolerance: none.  TA and weight deltas are integer counts, and every
comparison here is exact equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cotm as jcotm
from repro.core import train as jtrain
from repro.data.synthetic import prototype
from repro_torch.convert import params_from_arrays
from repro_torch.core import cotm as tcotm
from repro_torch.core import train as ttrain

# (boost_true_positive, specificity): the boosted default, and the
# unboosted path that reads the hi draw with a non-dyadic 1/s.
CONFIGS = [(True, 4.0), (False, 5.0)]


def _problem(boost, s, seed=0, n=192):
    kw = dict(n_literals=64, n_clauses=40, n_classes=4, n_states=64,
              threshold=16, specificity=s, boost_true_positive=boost)
    x, y = prototype(n, n_classes=4, n_features=32, flip=0.05, seed=seed)
    lits = np.concatenate([x, 1 - x], -1).astype(bool)
    rng = np.random.default_rng(seed)
    ta = rng.integers(1, 2 * 64 + 1, (64, 40)).astype(np.int32)
    w = rng.integers(-6, 7, (4, 40)).astype(np.int32)
    return (jcotm.CoTMConfig(**kw), tcotm.CoTMConfig(**kw), lits,
            y.astype(np.int32), ta, w)


def _jax_draws(key, B, cfg):
    """The reference's draws for ``batch_deltas(key)``, as the uniforms
    behind its Bernoulli masks; asserts the Bernoulli identity first."""
    K, n, m, s = cfg.n_literals, cfg.n_clauses, cfg.n_classes, \
        cfg.specificity
    k_neg, k_sel, k_hi, k_lo = jax.random.split(key, 4)
    u_sel = jax.random.uniform(k_sel, (2 * B, n))
    u_hi = jax.random.uniform(k_hi, (K, n))
    u_lo = jax.random.uniform(k_lo, (K, n))
    p = jnp.asarray(np.random.default_rng(B).random((2 * B, 1)),
                    jnp.float32)
    for k, prob, u, shape in ((k_sel, p, u_sel, (2 * B, n)),
                              (k_hi, (s - 1.0) / s, u_hi, (K, n)),
                              (k_lo, 1.0 / s, u_lo, (K, n))):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bernoulli(k, prob, shape)),
            np.asarray(u < prob))
    return ttrain.FeedbackDraws(
        neg_offset=torch.from_numpy(np.array(
            jax.random.randint(k_neg, (B,), 1, m))),
        u_sel=torch.from_numpy(np.array(u_sel)),
        u_lo=torch.from_numpy(np.array(u_lo)),
        u_hi=torch.from_numpy(np.array(u_hi)))


def _same(tparams, jparams):
    np.testing.assert_array_equal(tparams.ta_state.numpy(),
                                  np.asarray(jparams.ta_state))
    np.testing.assert_array_equal(tparams.weights.numpy(),
                                  np.asarray(jparams.weights))


@pytest.mark.parametrize("boost,s", CONFIGS)
def test_batch_deltas_bit_identical(boost, s):
    jcfg, tcfg, lits, y, ta, w = _problem(boost, s)
    key = jax.random.key(5)
    B = 48
    jp = jcotm.CoTMParams(jnp.asarray(ta), jnp.asarray(w))
    jta, jw = jtrain.batch_deltas(jp, jnp.asarray(lits[:B]),
                                  jnp.asarray(y[:B]), key, jcfg)
    tta, tw = ttrain.batch_deltas(
        params_from_arrays(ta, w, device="cpu"), torch.from_numpy(lits[:B]),
        torch.from_numpy(y[:B]), None, tcfg,
        draws=_jax_draws(key, B, jcfg))
    assert tta.dtype == tw.dtype == torch.int32
    np.testing.assert_array_equal(tta.numpy(), np.asarray(jta))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert int(np.abs(np.asarray(jta)).sum()) > 0


@pytest.mark.parametrize("boost,s", CONFIGS)
def test_train_step_batch_trajectory_bit_identical(boost, s):
    """Three batch steps from the same start walk the same TA/weight
    trajectory, step by step."""
    jcfg, tcfg, lits, y, ta, w = _problem(boost, s, seed=1)
    jp = jcotm.CoTMParams(jnp.asarray(ta), jnp.asarray(w))
    tp = params_from_arrays(ta, w, device="cpu")
    B = 64
    for step in range(3):
        key = jax.random.key(100 + step)
        sl = slice(step * B, (step + 1) * B)
        jp = jtrain.train_step_batch(jp, jnp.asarray(lits[sl]),
                                     jnp.asarray(y[sl]), key, jcfg)
        tp = ttrain.train_step_batch(tp, torch.from_numpy(lits[sl]),
                                     torch.from_numpy(y[sl]), None, tcfg,
                                     draws=_jax_draws(key, B, jcfg))
        _same(tp, jp)


def test_train_step_sequential_bit_identical():
    """The per-sample scan over one batch: sample ``i`` takes the
    reference's ``split(key, B)[i]`` draws."""
    jcfg, tcfg, lits, y, ta, w = _problem(True, 4.0, seed=2)
    B = 12
    key = jax.random.key(9)
    jp = jtrain.train_step_sequential(
        jcotm.CoTMParams(jnp.asarray(ta), jnp.asarray(w)),
        jnp.asarray(lits[:B]), jnp.asarray(y[:B]), key, jcfg)
    draws = [_jax_draws(k, 1, jcfg) for k in jax.random.split(key, B)]
    tp = ttrain.train_step_sequential(
        params_from_arrays(ta, w, device="cpu"), torch.from_numpy(lits[:B]),
        torch.from_numpy(y[:B]), None, tcfg, draws=draws)
    _same(tp, jp)


def test_train_epochs_learns_and_takes_permutations():
    """With a generator the port trains on its own: held-out accuracy
    rises from the untrained start; injected permutations replace the
    shuffle, and one generator seed reproduces a run."""
    _, tcfg, lits, y, _, _ = _problem(True, 4.0, seed=3, n=640)
    tr_l, tr_y = torch.from_numpy(lits[:512]), torch.from_numpy(y[:512])
    ho_l, ho_y = torch.from_numpy(lits[512:]), torch.from_numpy(y[512:])
    init = tcfg.init(torch.Generator().manual_seed(0))

    def run(seed, perms=None):
        return ttrain.train_epochs(init, tr_l, tr_y,
                                   torch.Generator().manual_seed(seed),
                                   tcfg, epochs=2, batch_size=32,
                                   perms=perms)

    def acc(p):
        return float((tcotm.predict(p, ho_l, tcfg) == ho_y).float().mean())

    a = run(1)
    assert acc(a) > acc(init) + 0.2
    b = run(1)
    assert torch.equal(a.ta_state, b.ta_state)
    ident = [torch.arange(512)] * 2
    c, d = run(2, ident), run(2, ident)
    assert torch.equal(c.ta_state, d.ta_state)
    assert not torch.equal(a.ta_state, c.ta_state)
    with pytest.raises(ValueError, match="generator or draws"):
        ttrain.batch_deltas(init, tr_l[:4], tr_y[:4], None, tcfg)

"""The port's CoTM readout head (``repro_torch.models.tm_head``) against
the reference's (``repro.models.tm_head``) on the same numpy features and
parameters.

Tolerance: none where the packages compute the same function.
Literals, include masks and class scores are integers or bits, and
``TMHead.scores`` on the port's ``"cuda"`` backend (the kernel's plain
version for CPU tensors) and ``"torch"`` equals the reference's
``impl="pallas"`` (interpret mode) and ``impl="xla"`` bit for bit.
``booleanize`` uses the population standard deviation (``jnp.std``'s
ddof 0), so the literals match exactly; the features are drawn so that
no squashed value lies within 1e-5 of a thermometer threshold, where an
ulp of the mean or deviation could flip one.  The two training tests are
the port's twins of ``tests/test_tm_head.py`` with their own generators:
their accuracy bounds (0.85, 0.9) are the reference's, statistical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cotm import CoTMParams as JParams
from repro.models import TMHead as JHead
from repro.models import pool_features as jpool
from repro.models.config import TMHeadConfig as JHeadConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_arrays
from repro_torch.models import TMHead, build, pool_features
from repro_torch.models.config import TMHeadConfig


def _features(n, d, n_classes, seed=0):
    """Class-clustered synthetic 'backbone features' (the reference
    test's recipe)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, d)) * 2.0
    y = rng.integers(0, n_classes, n)
    x = centers[y] + rng.normal(size=(n, d)) * 0.5
    return x.astype(np.float32), y.astype(np.int64)


def _heads(d, **kw):
    return (TMHead(TMHeadConfig(**kw), d_features=d),
            JHead(JHeadConfig(**kw), d_features=d))


def _sparse_params(K, n, m, n_states, seed):
    """TA states where each clause includes 1 to 6 literals (so clauses
    fire on random features), signed integer weights."""
    rng = np.random.default_rng(seed)
    ta = np.full((K, n), n_states, np.int32)
    for j in range(n):
        ta[rng.choice(K, int(rng.integers(1, 7)), replace=False), j] += 1
    w = rng.integers(-40, 40, (m, n)).astype(np.int32)
    return ta, w


def _far_from_thresholds(x, bits):
    """True when no squashed feature lies within 1e-5 of a threshold."""
    mu = x.mean(-1, keepdims=True)
    sd = x.std(-1, keepdims=True) + 1e-6
    sq = 1 / (1 + np.exp(-(x - mu) / sd))
    t = np.arange(1, bits + 1) / (bits + 1)
    return np.abs(sq[..., None] - t).min() > 1e-5


@pytest.mark.parametrize("bits", [1, 3])
def test_booleanize_matches(bits):
    x, _ = _features(96, 40, 4, seed=bits)
    assert _far_from_thresholds(x, bits)
    th, jh = _heads(40, bits_per_feature=bits)
    got = th.booleanize(torch.from_numpy(x)).numpy()
    want = np.asarray(jh.booleanize(jnp.asarray(x)))
    assert got.dtype == np.bool_ and got.shape == (96, 2 * 40 * bits)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d,m,n,bits,B", [(16, 3, 32, 1, 64),
                                          (40, 10, 97, 2, 37)])
def test_scores_bit_exact(d, m, n, bits, B):
    """``scores`` / ``predict`` on the port's ``"cuda"`` (plain version
    on the CPU) and ``"torch"`` against the reference's Pallas kernel in
    interpret mode and its XLA oracle."""
    th, jh = _heads(d, n_classes=m, n_clauses=n, bits_per_feature=bits)
    x, _ = _features(B, d, m, seed=d)
    assert _far_from_thresholds(x, bits)
    ta, w = _sparse_params(th.cotm_cfg.n_literals, n, m, 128, seed=n)
    jp = JParams(ta_state=jnp.asarray(ta), weights=jnp.asarray(w))
    tp = params_from_arrays(ta, w, device="cpu")
    want = np.asarray(jh.scores(jp, jnp.asarray(x), impl="pallas"))
    np.testing.assert_array_equal(
        want, np.asarray(jh.scores(jp, jnp.asarray(x), impl="xla")))
    assert (want != 0).any()                  # some clauses fire
    for impl in ("cuda", "torch"):
        got = th.scores(tp, torch.from_numpy(x), impl=impl)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            th.predict(tp, torch.from_numpy(x), impl=impl).numpy(),
            np.asarray(jh.predict(jp, jnp.asarray(x), impl="xla")))


def test_pool_features_matches():
    rng = np.random.default_rng(7)
    h = rng.standard_normal((3, 10, 8)).astype(np.float32)
    mask = rng.random((3, 10)) < 0.6
    mask[2] = False                            # an empty row
    for m in (None, mask):
        want = np.asarray(jpool(jnp.asarray(h),
                                None if m is None else jnp.asarray(m)))
        got = pool_features(torch.from_numpy(h),
                            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_init_and_cotm_config():
    th, jh = _heads(12, n_classes=4, n_clauses=20)
    assert th.cotm_cfg == type(th.cotm_cfg)(**{
        f: getattr(jh.cotm_cfg, f) for f in
        ("n_literals", "n_clauses", "n_classes", "n_states", "threshold",
         "specificity", "boost_true_positive")})
    p = th.init(device="cpu")
    assert p.ta_state.shape == (24, 20) and p.weights.shape == (4, 20)
    assert ((p.ta_state == 128) | (p.ta_state == 129)).all()
    assert not p.weights.any()
    again = th.init(torch.Generator().manual_seed(0))
    assert torch.equal(p.ta_state, again.ta_state)
    with pytest.raises(ValueError):
        th.init(torch.Generator(), device="meta")


def test_tm_head_learns_feature_classification():
    d, m = 32, 4
    head = TMHead(TMHeadConfig(n_classes=m, n_clauses=64,
                               bits_per_feature=2, n_states=64,
                               threshold=16), d_features=d)
    x, y = map(torch.from_numpy, _features(512, d, m))
    gen = torch.Generator().manual_seed(1)
    params = head.init(torch.Generator().manual_seed(0))
    for ep in range(15):
        for b in range(0, 512, 64):
            params = head.train_step(params, x[b:b + 64], y[b:b + 64], gen)
    acc = float((head.predict(params, x) == y).float().mean())
    assert acc > 0.85, acc


def test_tm_head_on_backbone_features():
    """Pool a (smoke) backbone's frozen embeddings of 2-class sequences
    and classify them with the TM head."""
    cfg = get_config("starcoder2-3b").smoke()
    model = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    B, S = 96, 48
    y = rng.integers(0, 2, B)
    toks = np.where(
        (rng.random((B, S)) < 0.95) == y[:, None].astype(bool),
        rng.integers(cfg.vocab // 2, cfg.vocab, (B, S)),
        rng.integers(0, cfg.vocab // 2, (B, S)))
    emb = model.params["embed"][torch.from_numpy(toks)]   # frozen
    feats = pool_features(emb)
    head = TMHead(TMHeadConfig(n_classes=2, n_clauses=128,
                               bits_per_feature=6, threshold=24),
                  d_features=cfg.d_model)
    hp = head.init(torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    labels = torch.from_numpy(y)
    for ep in range(60):
        hp = head.train_step(hp, feats, labels, gen)
    acc = float((head.predict(hp, feats) == labels).float().mean())
    assert acc > 0.9, acc

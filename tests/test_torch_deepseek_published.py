"""DeepSeek-V2-Lite at its published settings
(``configs.deepseek_v2_lite_16b.published()``: dropless routing, top-k
weights not renormalised, f32 router logits, YaRN) held to the
benchmark's plain reference (``perfbench/references/deepseek_v2.py``) on
the CPU, at the smoke widths with three layers (one dense, two MoE) of
eight experts, top 2, f32 weights drawn N(0, 0.02^2) from a seed.  The
attention's q, rope-key and key up-projections are drawn four times
larger, so that the attention logits are of order one: at 0.02 they are
near zero at these widths, attention is uniform whatever the rope, and
the YaRN departure would not show.

Each of today's three departures from the published model (capacity
factor 1.25, renormalised top-k, plain RoPE with 1/sqrt(qk_head_dim))
must break a tolerance, and does (``test_whole_model``).

Tolerances, each from the CPU's readings here:

* YaRN frequencies and angles: 1e-6 relative (f32 pow and products in
  another order; the departure moves them by O(1)).
* The MoE layer alone, f32 weights and activations: 1e-5 relative L2 a
  token (read 1.4e-7: f32 sums in another order).  The capacity path
  drops half its pairs under the skewed router (error ~1); renormalising
  the top-2 of 8 even probabilities scales them by ~4.
* The whole model's final states: 5e-3 relative L2 a position (read
  1.7e-3: the port rounds q, k, v and the attention probabilities to
  bf16 whatever the dtype, 2^-9 each, through three layers).  The
  departures read 2.7e-2 (capacity), 0.10 (renormalised) and 0.14
  (plain rope).  Pooled features: 5e-3 (read 1.6e-3).
* The classifier's literals: at most 1 of a document's 64 bits flipped
  (a feature within its rounding of the document's mean); the head's
  predictions equal the reference sweep's on the classifier's own
  literals, its energies to 1e-5 relative (f32 against f64).
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.families import cotm as cotm_family  # noqa: E402
from perfbench.references import cotm as cotm_ref  # noqa: E402
from perfbench.references import deepseek_v2 as ref  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.configs.deepseek_v2_lite_16b import (CONFIG,  # noqa: E402
                                                      YARN, published)
from repro_torch.models import TMHead, TMHeadConfig, build, ffn  # noqa: E402
from repro_torch.models import rope  # noqa: E402

BASE = dataclasses.replace(published(CONFIG.smoke()), n_layers=3,
                           dtype="float32", param_dtype="float32")
BASE = dataclasses.replace(BASE, moe=dataclasses.replace(
    BASE.moe, n_experts=8, top_k=2))
DEPARTURES = {
    "capacity_1.25": lambda c: dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, capacity_factor=1.25)),
    "renormalised": lambda c: dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, norm_topk_prob=True)),
    "plain_rope": lambda c: dataclasses.replace(c, rope_scaling=None),
}
ATTN_GAIN = 4.0
MOE_RTOL = 1e-5
HIDDEN_RTOL = 5e-3
FEATURE_RTOL = 5e-3
S, LENS = 64, (64, 40)


def _arch(cfg) -> ref.Arch:
    m = cfg.mla
    y = cfg.rope_scaling
    return ref.Arch(
        n_heads=cfg.n_heads, qk_nope_head_dim=m.qk_nope_head_dim,
        qk_rope_head_dim=m.qk_rope_head_dim, v_head_dim=m.v_head_dim,
        n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
        norm_topk_prob=False,
        yarn=None if y is None else dataclasses.asdict(y))


def _tree(mod) -> dict:
    """The module's parameters as the reference takes them (views)."""
    out = {k: v.detach() for k, v in mod._parameters.items()}
    for k, v in mod._modules.items():
        out[k] = ([_tree(x) for x in v]
                  if isinstance(v, torch.nn.ModuleList) else _tree(v))
    return out


@pytest.fixture(scope="module")
def model():
    m = build(BASE, device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in m.params.named_parameters():
            if name.endswith("gamma") or name.endswith("kv_norm"):
                p.zero_()
                continue
            p.normal_(0.0, 0.02, generator=g)
            if name.split(".")[-1] in ("wq", "w_kr", "w_uk"):
                p.mul_(ATTN_GAIN)
    return m


@pytest.fixture(scope="module")
def docs():
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, BASE.vocab, (len(LENS), S), generator=g)
    return tokens, torch.tensor(LENS)


@pytest.fixture(scope="module")
def answer(model, docs):
    tokens, _ = docs
    return ref.forward(_tree(model.params),
                       [tokens[i, :n] for i, n in enumerate(LENS)],
                       [torch.arange(n) for n in LENS], _arch(BASE))


def _rel(got, want):
    return (got - want).norm(dim=-1) / want.norm(dim=-1)


# -- configuration ---------------------------------------------------------

def test_published_settings_and_size():
    """Every published setting, and the published 15.7B parameters
    counted on the meta device; ``CONFIG`` itself keeps the reference's
    mathematics."""
    cfg = published()
    assert cfg.moe.capacity_factor is None
    assert cfg.moe.norm_topk_prob is False
    assert cfg.moe.router_f32
    assert cfg.rope_scaling == YARN and cfg.param_dtype == "bfloat16"
    assert build(cfg, device="meta").n_params() == 15_706_484_224
    assert CONFIG.rope_scaling is None and CONFIG.moe.capacity_factor == 1.25
    assert CONFIG.moe.norm_topk_prob and not CONFIG.moe.router_f32


def test_benchmark_configuration_builds_published():
    """The benchmark's configuration file (the catalog's keys) builds
    exactly ``published()``."""
    import json
    from perfbench.families import dsv2
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / "deepseek-v2-lite.json").read_text())
    assert dsv2.model_config(cfg) == published()


@pytest.mark.parametrize("where,setting", [
    ("port", "mscale"), ("family", "mscale"), ("reference", "mscale"),
    ("family", "routed_scaling_factor"),
    ("reference", "routed_scaling_factor")])
def test_unimplemented_settings_are_refused(where, setting):
    """A ``routed_scaling_factor`` other than 1 (DeepSeek-V2's 16) and YaRN
    whose ``mscale`` differs from ``mscale_all_dim`` (cos and sin scaled)
    are refused with a clear error by the port's ``YaRNConfig``, the
    benchmark family and the reference, not computed wrongly."""
    import json
    from perfbench.families import dsv2
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / "deepseek-v2-lite.json").read_text())
    if setting == "routed_scaling_factor":      # the port has no field
        cfg["routed_scaling_factor"] = 16.0
    else:
        cfg["rope_scaling"] = dict(cfg["rope_scaling"], mscale=1.0)
    build_it = {"port": lambda: dataclasses.replace(YARN, mscale=1.0),
                "family": lambda: dsv2.model_config(cfg),
                "reference": lambda: ref.Arch.from_config(cfg)}[where]
    with pytest.raises(ValueError, match=setting):
        build_it()


# -- YaRN --------------------------------------------------------------------

@pytest.mark.parametrize("head_dim", [8, 64])
def test_yarn_angles(head_dim):
    """YaRN's inverse frequencies and angles equal the reference's; the
    plain rope's differ."""
    arch = dataclasses.replace(_arch(published()), qk_rope_head_dim=head_dim)
    want = ref.inv_freq(arch, "cpu")
    got = rope.yarn_freqs(head_dim, 10_000.0, YARN)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    pos = torch.arange(4096)[None]
    np.testing.assert_allclose(
        rope.rope_angles(pos, head_dim, 10_000.0, YARN)[0].numpy(),
        (pos[0, :, None].float() * want).numpy(), rtol=1e-6, atol=1e-6)
    plain = rope.rope_freqs(head_dim, 10_000.0)
    assert (plain / want).max() > 2.0        # the departure is O(1)


def test_yarn_softmax_scale():
    """The softmax scale is 1/sqrt(192) times mscale(40, 0.707)^2 =
    1.5897, the reference's; plain rope's 1/sqrt(192) misses it."""
    m = rope.yarn_get_mscale(40.0, 0.707) ** 2
    assert m == pytest.approx((0.1 * 0.707 * math.log(40) + 1) ** 2)
    assert m == pytest.approx(1.5897, abs=1e-4)
    arch = _arch(published())
    assert ref.softmax_scale(arch) == pytest.approx(m / math.sqrt(192),
                                                    rel=1e-12)
    assert ref.softmax_scale(dataclasses.replace(arch, yarn=None)) \
        == pytest.approx(1 / math.sqrt(192))


# -- routing -----------------------------------------------------------------

def _moe_case(model, skew: bool):
    """Tokens with a common direction and, with ``skew``, a router that
    sends most of them to expert 0."""
    g = torch.Generator().manual_seed(5)
    d = BASE.d_model
    x = torch.randn(2, 48, d, generator=g)
    v = torch.randn(d, generator=g)
    p = dict(_tree(model.params)["layers"][0]["moe"])
    if skew:
        x = x + 1.5 * v
        bias = torch.zeros(BASE.moe.n_experts)
        bias[0] = 0.2
        p["router"] = p["router"] * 3 + v[:, None] * bias
    want = ref.moe(ref.Ops("float32", 1e-6), _arch(BASE), p,
                   x.reshape(-1, d)).reshape(x.shape)
    return p, x, want


def _moe(p, x, cfg):
    tracing.reset()
    tracing.enable()
    try:
        got, _ = ffn.moe_forward(p, x, cfg)
        tracing.flush()
        return got, {k: v["count"] for k, v in tracing.totals().items()}
    finally:
        tracing.disable()
        tracing.reset()


@pytest.mark.parametrize("case", ["published", "capacity_1.25"])
def test_dropless_routing_under_skew(model, case):
    """Some expert gets more than 1.25x its share: the dropless path
    computes every pair (rows = pairs, nothing dropped) and matches the
    reference; capacity 1.25 drops pairs and misses it."""
    p, x, want = _moe_case(model, skew=True)
    cfg = BASE if case == "published" else DEPARTURES[case](BASE)
    got, c = _moe(p, x, cfg)
    share = c["moe.max_slots"] / c["moe.mean_slots"]
    assert share > 1.25
    err = float(_rel(got, want).max())
    if case == "published":
        assert err < MOE_RTOL
        assert c["moe.dropped"] == 0 and c["moe.rows"] == c["moe.slots"]
    else:
        assert err > MOE_RTOL and c["moe.dropped"] > 0
        assert c["moe.rows"] >= 1.25 * c["moe.slots"]


@pytest.mark.parametrize("case", ["published", "renormalised"])
def test_top_k_weights_not_renormalised(model, case):
    """The top-k softmax probabilities weigh the experts as they are
    (``norm_topk_prob: false``); renormalising them misses the
    reference."""
    p, x, want = _moe_case(model, skew=False)
    cfg = BASE if case == "published" else DEPARTURES[case](BASE)
    err = float(_rel(_moe(p, x, cfg)[0], want).max())
    assert (err < MOE_RTOL) == (case == "published"), err


def test_dropless_refuses_training(model):
    p, x, _ = _moe_case(model, skew=False)
    with pytest.raises(NotImplementedError):
        ffn.moe_forward(p, x.requires_grad_(), BASE)


# -- the whole model ---------------------------------------------------------

@pytest.mark.parametrize("case", ["published"] + list(DEPARTURES))
def test_whole_model(model, docs, answer, case):
    """Final (normed) states at every valid position and the pooled
    features against the reference; each departure breaks the states'
    tolerance."""
    tokens, lengths = docs
    model.cfg = BASE if case == "published" else DEPARTURES[case](BASE)
    try:
        pos = torch.arange(S).expand(len(LENS), S)
        with torch.no_grad():
            h = model.normed(model.hidden(tokens, pos)[0])
    finally:
        model.cfg = BASE
    err = max(float(_rel(h[i, :n], answer.hidden[i]).max())
              for i, n in enumerate(LENS))
    feat = max(float(_rel(h[i, :n].mean(0), answer.features[i]))
               for i, n in enumerate(LENS))
    if case == "published":
        assert err < HIDDEN_RTOL and feat < FEATURE_RTOL, (err, feat)
    else:
        assert err > HIDDEN_RTOL, err


def test_adopt_takes_the_tensors(model):
    """``adopt`` makes a meta-built model hold the given tensors
    themselves, and refuses a leaf of another shape."""
    tree = _tree(model.params)
    m = build(BASE, device="meta").adopt(tree)
    assert m.params["embed"].data_ptr() == tree["embed"].data_ptr()
    assert (m.params["layers"][1]["moe"]["w_up"].data_ptr()
            == tree["layers"][1]["moe"]["w_up"].data_ptr())
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError):
        build(BASE, device="meta").adopt(bad)


# -- the classifier ------------------------------------------------------------

def _head_system(gen):
    from repro_torch.convert import system_from_arrays
    from repro_torch.impact.yflash import read_current
    head = dict(n_literals=2 * BASE.d_model, n_clauses=20, n_classes=10,
                max_tile_rows=64, max_tile_cols=16, max_class_rows=16,
                assumed=dict(include_density=0.05, fired_share=0.176,
                             weights=[-61, 53], lcs_s=0.9e-9,
                             lcs_sd_rel=0.044, hcs_s=2.5e-6,
                             hcs_sd_rel=0.0265, class_sd_s=27.6e-9,
                             class_tol_segments=5))
    dep = cotm_family.deploy(head, gen)
    host = lambda t: t.numpy()
    system = system_from_arrays(dict(
        clause_g=host(dep.clause_g), nonempty=host(dep.nonempty),
        class_g=host(dep.class_g), clause_i=host(read_current(dep.clause_g)),
        class_i=host(read_current(dep.class_g)), n_literals=head[
            "n_literals"], n_clauses=20, n_classes=10, program_energy_j=0.0,
        erase_energy_j=0.0, cfg=dict(max_tile_rows=64, max_tile_cols=16,
                                     max_class_rows=16)), device="cpu")
    return dep, system


def test_classifier_against_the_reference(model, docs, answer):
    """``Classifier.classify``: literals as the reference's but for at
    most one bit a document, the head's answers equal to the reference
    sweep on the classifier's own literals, the checked states the
    reference's."""
    from repro_torch.serve import Classifier
    dep, system = _head_system(torch.Generator().manual_seed(7))
    head = TMHead(TMHeadConfig(n_clauses=20, n_classes=10), BASE.d_model)
    clf = Classifier(model, head, system, capacity=len(LENS), device="cpu")
    tokens, lengths = docs
    positions = torch.stack([torch.tensor([0, n // 2, n - 1]) for n in LENS])
    tracing.reset()
    tracing.enable()
    try:
        c = clf.classify(tokens, lengths, positions)
        counts = {k: v["count"] for k, v in tracing.totals().items()}
    finally:
        tracing.disable()
        tracing.reset()
    assert counts["lm.valid_tokens"] == sum(LENS)
    assert counts["lm.tokens"] == len(LENS) * S
    flips = (c.literals.long() != answer.literals.long()).sum(dim=1)
    assert int(flips.max()) <= 1, flips
    for i, n in enumerate(LENS):
        want = answer.hidden[i][positions[i]]
        assert float(_rel(c.hidden[i], want).max()) < HIDDEN_RTOL
    scores, e_cl, e_cs = cotm_ref.sweep(c.literals, dep.clause_g,
                                        dep.nonempty, dep.class_g)
    res = c.result
    np.testing.assert_array_equal(res.predictions.numpy(),
                                  scores.argmax(dim=1).numpy())
    np.testing.assert_allclose(res.e_clause_lanes.double().numpy(),
                               e_cl.numpy(), rtol=1e-5)
    np.testing.assert_allclose(res.e_class_lanes.double().numpy(),
                               e_cs.numpy(), rtol=1e-5, atol=1e-30)

"""The MLA prefill flash kernel (``repro_torch.kernels.flash_attention``):
its plain version against the port's ``chunked_attention`` (whose chunks
``_flash_rows`` walks) and the JAX package's, the dispatch in
``mla_forward``, the two counters, and, on a card, the kernel against its
plain version.

Tolerances.  The plain version rounds where ``_flash_rows`` rounds (q, k,
v and the probabilities to bf16, statistics and sums in f32), but on
128-key tiles, where ``mla_forward``'s chunked call takes 2,048 keys a
chunk: a probability is rounded to bf16 (2^-9 relative at most) against
the running max of its own tile, not of its chunk, so the two round it
differently wherever the maxima differ.  On logits of standard deviation
two that reads a relative L2 error of 2.0e-4 to 7.2e-4 and a largest
difference of 1.3e-3 to 2.1e-3 (|v| ~ 1) on the CPU; the bounds are
4e-3 and 8e-3.  Where one tile holds every key (S <= 128) the maxima
agree and only the f32 order of summation differs from the port: read 0
to 2.4e-7, bound 1e-5.  The JAX package rounds at the same points as the
port, but its f32 ``exp`` can differ from PyTorch's by an ulp, which
moves a probability's bf16 rounding by one ulp where it falls near a
rounding boundary: the port and the JAX package themselves read 7.9e-6
relative L2 and 1.5e-4 largest at S = 100 and 2.0e-3 largest at S = 300.
So the JAX package takes the bounds of another rounding of P, 4e-3 and
8e-3, at every S.

On the card the kernel and the plain version compute the same tiles;
they differ in the order of summation and in the kernel's ``exp2f`` of
log2(e)-scaled logits against ``torch.exp``, which can move a
probability's bf16 rounding by one ulp.  Read at f32 output: relative L2
3.4e-5, largest difference 6.3e-4 at (2, 300, 3); bounds 2e-4 and 4e-3.
Two runs of the kernel are bitwise equal (no atomics, a fixed order).
The card's tests skip without one: ``PYTHONPATH=src python -m pytest -q
-o addopts= tests/test_torch_flash_attention.py -m card``.
"""
import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG, published
from repro_torch.kernels import flash_attention as flash
from repro_torch.models import attention as tattn
from repro_torch.models.config import MLAConfig

REL_L2, MAX_ABS = 4e-3, 8e-3          # P rounded against another max
ONE_TILE = 1e-5                        # the same max: f32 order only
CARD_REL_L2, CARD_MAX_ABS = 2e-4, 4e-3
SCALE = 1.0 / math.sqrt(192)

# (B, S, H): S not a multiple of 128, S < 128, one whole tile, whole
# tiles past the first, and lengths past the 512-query and 2,048-key
# chunks.
CASES = {
    "ragged": (2, 300, 3),
    "short": (2, 100, 2),
    "one_tile": (1, 128, 2),
    "whole_tiles": (2, 384, 2),
    "chunks": (1, 2200, 1),
}


@pytest.fixture(autouse=True)
def table():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _operands(B, S, H, seed=0):
    """q (B, S, H, 192), k_nope (B, S, H, 128), the shared rope key (B,
    S, 64) and v (B, S, H, 128), f32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, 192)).astype(np.float32) * 2
    kn = rng.standard_normal((B, S, H, 128)).astype(np.float32)
    kr = rng.standard_normal((B, S, 64)).astype(np.float32)
    v = rng.standard_normal((B, S, H, 128)).astype(np.float32)
    return q, kn, kr, v


def _mla_args(q, kn, kr, v):
    """``flash_prefill``'s arguments: q and k as their parts."""
    q, kn, kr, v = (torch.as_tensor(x) for x in (q, kn, kr, v))
    return (q[..., :128], q[..., 128:]), (kn, kr), v


def _whole_k(kn, kr):
    """k (B, S, H, 192): the shared rope key expanded over heads."""
    B, S, H, _ = kn.shape
    return np.concatenate(
        [kn, np.broadcast_to(kr[:, :, None, :], (B, S, H, 64))], axis=-1)


def _errors(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (np.linalg.norm(got - want) / np.linalg.norm(want),
            np.abs(got - want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_chunked_attention(case):
    """The plain version (MLA's layout: q and k as parts, one shared rope
    key) against the port's ``chunked_attention`` and the JAX package's
    on the whole operands, at ``mla_forward``'s chunks (512 queries,
    2,048 keys, each cut to S), causal from position 0."""
    import jax.numpy as jnp
    from repro.models import attention as jattn

    B, S, H = CASES[case]
    q, kn, kr, v = _operands(B, S, H)
    k = _whole_k(kn, kr)
    kw = dict(scale=SCALE, q_chunk=min(512, S), k_chunk=min(2048, S))
    got = flash.flash_prefill(*_mla_args(q, kn, kr, v), scale=SCALE,
                              out_dtype=torch.float32).numpy()
    port = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                   **kw).numpy()
    jax_ = np.asarray(jattn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                              **kw))
    assert np.isfinite(got).all()
    rel, err = _errors(got, port)
    if S <= flash.TILE_K:
        assert rel < ONE_TILE and err < ONE_TILE, (rel, err)
    else:
        assert rel < REL_L2 and err < MAX_ABS, (rel, err)
    rel, err = _errors(got, jax_)
    assert rel < REL_L2 and err < MAX_ABS, (rel, err)


def test_plain_rounds_f32_operands_to_bf16():
    """f32 operands are rounded to bf16 first, so bf16 ones give the same
    bits; the output is bf16 unless asked for f32."""
    q, kn, kr, v = _operands(2, 150, 3)
    args = _mla_args(q, kn, kr, v)
    f32 = flash.flash_prefill(*args, scale=SCALE, out_dtype=torch.float32)
    bf = flash.flash_prefill(
        *_mla_args(*(torch.from_numpy(x).bfloat16() for x in (q, kn, kr, v))),
        scale=SCALE, out_dtype=torch.float32)
    assert torch.equal(f32, bf)
    assert flash.flash_prefill(*args, scale=SCALE).dtype == torch.bfloat16


def _refused(name):
    """``flash_prefill``'s arguments with one outside its contract."""
    q, kn, kr, v = (torch.from_numpy(x) for x in _operands(1, 64, 2))
    qp, kp = (q[..., :128], q[..., 128:]), (kn, kr)
    return {
        # a rope key a head (B, S, H, 64) rather than one shared by all
        "rope_key_a_head": (qp, (kn, kr[:, :, None].expand(1, 64, 2, 64)),
                            v),
        # keys longer than the queries (a query offset)
        "longer_keys": (qp, (torch.cat([kn, kn], 1), torch.cat([kr, kr], 1)),
                        torch.cat([v, v], 1)),
        # whole 192-dim operands rather than their parts
        "whole_operands": (q, torch.cat(
            [kn, kr[:, :, None].expand(1, 64, 2, 64)], -1), v),
        # another v width
        "v_width": (qp, kp, v[..., :64]),
    }[name]


@pytest.mark.parametrize("name", ["rope_key_a_head", "longer_keys",
                                  "whole_operands", "v_width"])
def test_refuses_what_the_kernel_does_not_take(name):
    """Anything but causal self-attention in MLA's layout raises, on the
    CPU as on a card, before any arithmetic."""
    with pytest.raises(ValueError):
        flash.flash_prefill(*_refused(name), scale=SCALE)


def test_block_constants_match_the_source():
    """The wrapper's tiles, block and shared memory are the CUDA
    source's (``analysis.smem`` prices the block from them)."""
    from repro_torch.analysis import smem
    c = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);",
        (flash._build.CSRC / flash.SOURCE).read_text())}
    assert (flash.TILE_Q, flash.TILE_K, flash.D_NOPE, flash.D_ROPE,
            flash.D_V, flash.STAGES, flash.THREADS) == (
        c["BQ"], c["BK"], c["D_NOPE"], c["D_ROPE"], c["DV"], c["STAGES"],
        c["THREADS"])
    panel = 128 * c["PANEL"] * 2
    assert flash.SMEM_BYTES == ((3 + flash.STAGES * 5) * panel
                                + c["BARRIER_BYTES"] + 1024)
    ws = smem.flash_working_set()
    assert ws.smem_bytes == flash.SMEM_BYTES <= smem.DEFAULT_SMEM_BUDGET_BYTES
    assert smem.blocks_per_sm(168, ws.threads, ws.smem_bytes) == 1


def test_causal_work_counts_the_triangle_and_one_rope_key():
    """The FLOPs of the causal triangle, 2 (192 + 128) a visible pair;
    the bytes of q, k_nope, v, the output a head and the shared rope key
    once, in bf16."""
    flops, moved = flash.causal_work(4, 3, 2)
    assert flops == 2 * 320 * (1 + 2 + 3 + 4) * 3 * 2
    assert moved == 2 * 2 * 4 * (3 * (192 + 128 + 128 + 128) + 64)


def _mla_layer(dtype=torch.float32, device="cpu", grad=False):
    """One MLA layer at the published head dims (128 + 64, v 128) and a
    small width, its weights drawn from a seed."""
    cfg = published(CONFIG.smoke())
    cfg = dataclasses.replace(cfg, n_heads=2, mla=MLAConfig(
        kv_lora_rank=32, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128))
    g = torch.Generator().manual_seed(0)
    p = {}
    for name, d in tattn.decls_mla(cfg).items():
        t = torch.randn(d.shape, generator=g) * 0.1
        if name == "kv_norm":
            t.zero_()
        p[name] = t.to(device=device, dtype=dtype).requires_grad_(grad)
    x = torch.randn((2, 200, cfg.d_model), generator=g).to(device, dtype)
    pos = torch.arange(200, device=device).expand(2, 200)
    return cfg, p, x, pos


def _counts():
    t = tracing.totals()
    return tuple(t.get(n, {"count": 0})["count"]
                 for n in ("attn.kernel_calls", "attn.plain_calls"))


@pytest.mark.parametrize("grad", [False, True])
def test_mla_on_the_cpu_keeps_chunked_attention(grad):
    """On the CPU, with or without grad, ``mla_forward``'s prefill goes
    through ``chunked_attention`` (one plain call, no kernel call)."""
    cfg, p, x, pos = _mla_layer(grad=grad)
    tracing.enable()
    out, cache = tattn.mla_forward(p, x, pos, cfg)
    assert cache is None and out.shape == x.shape
    assert _counts() == (0, 1)


def test_counters_count_while_recording():
    """``attn.plain_calls`` counts each ``chunked_attention`` call while
    the table records, nothing otherwise; the plain ``flash_prefill``
    (a CPU tensor) is no kernel call."""
    q, kn, kr, v = _operands(1, 64, 1)
    k = torch.from_numpy(_whole_k(kn, kr))
    qt, vt = torch.from_numpy(q), torch.from_numpy(v)
    kw = dict(scale=SCALE, q_chunk=32, k_chunk=32)
    tattn.chunked_attention(qt, k, vt, **kw)
    assert _counts() == (0, 0)
    tracing.enable()
    for _ in range(3):
        tattn.chunked_attention(qt, k, vt, **kw)
    flash.flash_prefill(*_mla_args(q, kn, kr, v), scale=SCALE)
    assert _counts() == (0, 3)


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none (decided when the test
    runs, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("shape", [(8, 4096, 16), (3, 1000, 16)])
def test_card_kernel_matches_plain(card, shape):
    """The kernel against its plain version on the card at the cell's
    largest batch and at a ragged one, MLA's layout (q and k as parts, one
    shared rope key), f32 and bf16 output; two runs bitwise equal."""
    B, S, H = shape
    g = torch.Generator(device=card).manual_seed(1)
    q = (torch.randn(B, S, H, 192, device=card, generator=g) * 2).bfloat16()
    kn = torch.randn(B, S, H, 128, device=card, generator=g).bfloat16()
    kr = torch.randn(B, S, 64, device=card, generator=g).bfloat16()
    v = torch.randn(B, S, H, 128, device=card, generator=g).bfloat16()
    args = ((q[..., :128], q[..., 128:].contiguous()), (kn, kr), v)
    before = flash.KERNEL.launches
    got = flash.flash_prefill(*args, scale=SCALE, out_dtype=torch.float32)
    again = flash.flash_prefill(*args, scale=SCALE, out_dtype=torch.float32)
    got_bf = flash.flash_prefill(*args, scale=SCALE)
    torch.cuda.synchronize()
    assert flash.KERNEL.launches == before + 3
    want = flash.flash_prefill_ref(*args, scale=SCALE,
                                   out_dtype=torch.float32)
    assert torch.equal(got, again)
    rel, err = _errors(got.cpu(), want.cpu())
    assert rel < CARD_REL_L2 and err < CARD_MAX_ABS, (rel, err)
    # bf16 output: the f32 output rounded once (half an ulp, 2^-9).
    assert torch.equal(got_bf, got.bfloat16())


@pytest.mark.card
def test_card_mla_takes_the_kernel(card):
    """On the card ``mla_forward``'s prefill takes the kernel (one kernel
    call, no plain call) and agrees with the chunked path, which it takes
    under grad (one plain call)."""
    cfg, p, x, pos = _mla_layer(torch.bfloat16, card)
    tracing.enable()
    with torch.no_grad():
        out, _ = tattn.mla_forward(p, x, pos, cfg)
    assert _counts() == (1, 0)
    tracing.reset()
    _, pg, _, _ = _mla_layer(torch.bfloat16, card, grad=True)
    want, _ = tattn.mla_forward(pg, x, pos, cfg)
    assert _counts() == (0, 1)
    rel = ((out.float() - want.detach().float()).norm()
           / want.detach().float().norm()).item()
    assert rel < 1e-2, rel

"""Plain PyTorch reference of DeepSeek-V2-Lite's published forward, pooled
into the literals of a CoTM head: what the document classifier must
answer for each document, worked out from the weights in float32.

It imports torch, nothing of the program and nothing of JAX, and sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False, so every float32 product on a
card is IEEE float32.  The definition followed is the model's
``modeling_deepseek.py`` at the settings of its ``config.json``
(arXiv:2405.04434):

* the token embedding, then 27 layers of ``x + attn(norm(x))`` and
  ``x + ffn(norm(x))`` with RMSNorm (eps 1e-6);
* multi-head latent attention without a cache and without a query
  low-rank: q = x Wq (16 heads of 128 + 64), the 512-wide latent
  ``kv_a_layernorm``-ed, one rope key shared by the heads, k_nope and v
  up-projected from the latent, YaRN frequencies on the rope parts, the
  softmax scale 1/sqrt(192) times ``yarn_get_mscale(40, 0.707) ** 2``,
  causal, the softmax in float32;
* layer 0 a dense SwiGLU of width 10,944;
* layers 1-26 the MoE: float32 router logits, softmax, greedy top-6,
  the weights not renormalised (``norm_topk_prob: false``; the
  published ``routed_scaling_factor`` is 1, and ``Arch.from_config``
  refuses any other), every picked expert computed (an index
  select a expert, over the 64), and the shared SwiGLU of width 2 x
  1,408 added;
* the final RMSNorm; the mean over the document's positions; the
  head's literals by a thermometer of one bit over the features
  standardised by their own mean and population deviation, squashed by
  a logistic, ``[bits, ~bits]``.

Departures of layout from the published checkpoint, none of the
mathematics:

* a norm's gain is stored as ``gamma`` and applied as ``1 + gamma``
  (the published ``weight`` is ``1 + gamma``);
* ``kv_a_proj_with_mqa`` is stored as two matrices, ``w_dkv`` (the 512
  latent columns) and ``w_kr`` (the 64 rope columns);
* the published file's rope dimensions are interleaved and de-interleaved
  before rotation (``view(..., d // 2, 2).transpose``); here the rope
  columns of ``wq`` and ``w_kr`` are stored already de-interleaved and
  rotated by halves, a fixed permutation of those columns;
* the weights are the program's tree: ``wq`` (d, H, 192), ``w_uk`` /
  ``w_uv`` (512, H, 128), ``wo`` (H, 128, d), the experts' ``w_gate`` /
  ``w_up`` (E, d, f) and ``w_down`` (E, f, d), every matrix as
  ``x @ W``.

``forward`` works layer by layer over a list of documents: one layer's
bf16 weights are cast to float32 at a time, attention runs one document
at a time, and the per-token layers run over the documents' tokens in
blocks, so it fits beside the program's weights on the card.

``precision="e4m3"`` is the correctness control: the same forward with
every matrix product's operands rounded to 3 mantissa bits (e4m3's), to
nearest even, by the bit trick of ``references/cotm.to_tf32`` (the
exponent keeps float32's range).
"""
from __future__ import annotations

import dataclasses
import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PRECISIONS = ("float32", "e4m3")
#: Tokens a block of the per-token layers.
BLOCK = 32768


@dataclasses.dataclass(frozen=True)
class Arch:
    """The published sizes and settings the forward reads."""
    n_heads: int = 16
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_experts: int = 64
    top_k: int = 6
    norm_topk_prob: bool = False
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # rope_scaling (type "yarn"); None for plain rope
    yarn: dict | None = dataclasses.field(default_factory=lambda: dict(
        factor=40.0, original_max_position_embeddings=4096, beta_fast=32.0,
        beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707))

    @staticmethod
    def from_config(cfg: dict) -> "Arch":
        """From the keys of the published ``config.json``; refuses the
        settings this forward does not compute: a ``routed_scaling_factor``
        other than 1, and YaRN whose ``mscale`` differs from
        ``mscale_all_dim`` (which scales cos and sin)."""
        y = cfg.get("rope_scaling")
        if cfg["routed_scaling_factor"] != 1:
            raise ValueError(f"routed_scaling_factor "
                             f"{cfg['routed_scaling_factor']} is not 1")
        if y is not None and y["mscale"] != y["mscale_all_dim"]:
            raise ValueError(f"YaRN mscale {y['mscale']} != mscale_all_dim "
                             f"{y['mscale_all_dim']}")
        return Arch(
            n_heads=cfg["num_attention_heads"],
            qk_nope_head_dim=cfg["qk_nope_head_dim"],
            qk_rope_head_dim=cfg["qk_rope_head_dim"],
            v_head_dim=cfg["v_head_dim"],
            n_experts=cfg["n_routed_experts"],
            top_k=cfg["num_experts_per_tok"],
            norm_topk_prob=cfg["norm_topk_prob"],
            rms_norm_eps=cfg["rms_norm_eps"],
            rope_theta=float(cfg["rope_theta"]),
            yarn=None if y is None else {k: v for k, v in y.items()
                                         if k != "type"})


def to_e4m3_mantissa(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to 3 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x7FFFF + ((i >> 20) & 1)) & ~0xFFFFF
    return i.view(torch.float32)


def yarn_get_mscale(scale: float, mscale: float) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def inv_freq(arch: Arch, device) -> torch.Tensor:
    """The rope dimensions' inverse frequencies (``dim // 2``,), YaRN's as
    ``DeepseekV2YarnRotaryEmbedding`` computes them."""
    dim, base = arch.qk_rope_head_dim, arch.rope_theta
    steps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** steps
    y = arch.yarn
    if y is None:
        return extra
    inter = 1.0 / (y["factor"] * base ** steps)

    def corr(rot):
        return (dim * math.log(y["original_max_position_embeddings"]
                               / (rot * 2 * math.pi))) / (2 * math.log(base))
    low = max(math.floor(corr(y["beta_fast"])), 0)
    high = min(math.ceil(corr(y["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def softmax_scale(arch: Arch) -> float:
    scale = (arch.qk_nope_head_dim + arch.qk_rope_head_dim) ** -0.5
    y = arch.yarn
    if y is not None and y.get("mscale_all_dim"):
        scale *= yarn_get_mscale(y["factor"], y["mscale_all_dim"]) ** 2
    return scale


def cos_sin(arch: Arch, L: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos, sin (L, dim) of positions 0..L-1 (YaRN's cos / sin factor,
    ``mscale / mscale_all_dim``, is 1: ``Arch.from_config``)."""
    t = torch.arange(L, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq(arch, device))
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (L, ..., dim) rotated by halves (``rotate_half``)."""
    h = x.shape[-1] // 2
    rot = torch.cat([-x[..., h:], x[..., :h]], dim=-1)
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    return x * cos.view(shape) + rot * sin.view(shape)


class Ops:
    """The forward's products and norms at a precision."""

    def __init__(self, precision: str, eps: float):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.round = precision == "e4m3"
        self.eps = eps

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.round:
            a, b = to_e4m3_mantissa(a), to_e4m3_mantissa(b)
        return a @ b

    def norm(self, x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
        var = x.square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * (1.0 + gamma)

    def swiglu(self, x, w_gate, w_up, w_down) -> torch.Tensor:
        g = self.mm(x, w_gate)
        return self.mm(torch.nn.functional.silu(g) * self.mm(x, w_up),
                       w_down)


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def attention(ops: Ops, arch: Arch, a: dict, h: torch.Tensor,
              cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """One document's latent attention: h (L, d) normed -> (L, d)."""
    L, d = h.shape
    H, nope, rdim = arch.n_heads, arch.qk_nope_head_dim, arch.qk_rope_head_dim
    q = ops.mm(h, a["wq"].reshape(d, -1)).view(L, H, nope + rdim)
    ckv = ops.norm(ops.mm(h, a["w_dkv"]), a["kv_norm"])        # (L, r)
    k_pe = rotate(ops.mm(h, a["w_kr"]), cos, sin)              # (L, rdim)
    q_pe = rotate(q[..., nope:], cos, sin)                     # (L, H, rdim)
    r = ckv.shape[-1]
    k_nope = ops.mm(ckv, a["w_uk"].reshape(r, -1)).view(L, H, nope)
    v = ops.mm(ckv, a["w_uv"].reshape(r, -1)).view(L, H, -1)
    qh = torch.cat([q[..., :nope], q_pe], dim=-1).transpose(0, 1)
    kh = torch.cat([k_nope, k_pe[:, None, :].expand(L, H, rdim)],
                   dim=-1).transpose(0, 1)                      # (H, L, 192)
    scores = ops.mm(qh, kh.transpose(1, 2)) * softmax_scale(arch)
    causal = torch.ones(L, L, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    o = ops.mm(p, v.transpose(0, 1)).transpose(0, 1)           # (L, H, dv)
    return ops.mm(o.reshape(L, -1), a["wo"].reshape(-1, d))


def moe(ops: Ops, arch: Arch, m: dict, h: torch.Tensor) -> torch.Tensor:
    """The MoE of tokens h (T, d) normed -> (T, d): every routed expert
    computed, the shared experts added."""
    logits = ops.mm(h, m["router"])
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, arch.top_k, dim=-1)
    if arch.norm_topk_prob:
        top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
    out = torch.zeros_like(h)
    for e in range(arch.n_experts):
        tok, j = torch.nonzero(top_e == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = ops.swiglu(h.index_select(0, tok), m["w_gate"][e], m["w_up"][e],
                       m["w_down"][e])
        out.index_add_(0, tok, y * top_w[tok, j, None])
    s = m["shared"]
    return out + ops.swiglu(h, s["w_gate"], s["w_up"], s["w_down"])


def literals(features: torch.Tensor) -> torch.Tensor:
    """features (N, d) -> literals (N, 2d) int8, ``[bits, ~bits]``: one
    thermometer bit a feature at 1/2 of the logistic of the feature over
    the document's own mean and population deviation."""
    mu = features.mean(dim=-1, keepdim=True)
    sd = features.std(dim=-1, keepdim=True, correction=0) + 1e-6
    bits = torch.sigmoid((features - mu) / sd) > 0.5
    return torch.cat([bits, ~bits], dim=-1).to(torch.int8)


@dataclasses.dataclass
class Answer:
    """The reference's answer for documents, in float32."""
    hidden: list        # each document's final (normed) states (P, d)
    features: torch.Tensor   # (N, d) the mean over each document
    literals: torch.Tensor   # (N, 2d) int8


def forward(weights: dict, docs: list[torch.Tensor],
            positions: list[torch.Tensor], arch: Arch = Arch(), *,
            precision: str = "float32") -> Answer:
    """The published forward of each document of ``docs`` (1-D token
    ids), its final states at ``positions`` (one index tensor a
    document), its pooled features and literals.  ``weights`` is the
    program's tree on the card: ``embed``, ``final_norm``, ``front`` (the
    dense layer) and ``layers`` (the MoE layers), each layer with
    ``ln1``, ``ln2``, ``attn`` and ``mlp`` or ``moe``."""
    ops = Ops(precision, arch.rms_norm_eps)
    dev = weights["embed"].device
    lens = [int(t.numel()) for t in docs]
    tokens = torch.cat([t.to(dev).long() for t in docs])
    x = weights["embed"].index_select(0, tokens).float()       # (T, d)
    cos, sin = cos_sin(arch, max(lens), dev)
    cuts = [0]
    for n in lens:
        cuts.append(cuts[-1] + n)
    for raw in list(weights["front"]) + list(weights["layers"]):
        w = _f32(raw)
        attn = torch.empty_like(x)
        for i, L in enumerate(lens):
            xs = x[cuts[i]:cuts[i + 1]]
            attn[cuts[i]:cuts[i + 1]] = attention(
                ops, arch, w["attn"], ops.norm(xs, w["ln1"]["gamma"]),
                cos[:L], sin[:L])
        x = x + attn
        for b0 in range(0, x.shape[0], BLOCK):
            xs = x[b0:b0 + BLOCK]
            h = ops.norm(xs, w["ln2"]["gamma"])
            if "moe" in w:
                f = moe(ops, arch, w["moe"], h)
            else:
                f = ops.swiglu(h, w["mlp"]["w_gate"], w["mlp"]["w_up"],
                               w["mlp"]["w_down"])
            x[b0:b0 + BLOCK] = xs + f
        del w
    x = ops.norm(x, weights["final_norm"]["gamma"].float())
    hidden, feats = [], []
    for i, pos in enumerate(positions):
        doc = x[cuts[i]:cuts[i + 1]]
        hidden.append(doc.index_select(0, pos.to(dev).long()))
        feats.append(doc.mean(dim=0))
    features = torch.stack(feats)
    return Answer(hidden, features, literals(features))

"""The work of DeepSeek-V2-Lite's forward over a batch of documents, from
the published architecture and the documents' valid lengths, and the
H100's published bf16 peak, frozen.

The count is the benchmark's own: what the published forward must do
for the valid tokens, whatever kernels do it and however the program
pads.  Operations are two a multiply-add.  A token's projections: each
of the 27 layers' latent attention (``wq``, the latent and rope-key
down-projections, the key and value up-projections, ``wo``), the dense
SwiGLU of layer 0, and in each of the 26 MoE layers the router and the
SwiGLUs of its 6 routed and 2 shared experts.  No LM head.  Causal
attention adds, a layer, ``2 * heads * (qk_head_dim + v_head_dim)``
operations for each (query, key) pair a document's causal mask keeps.
Bytes: the weights a batch must read (every layer's, the routed experts
all counted; the embedding's rows of its valid tokens; no LM head), the
token ids in and each document's literals, prediction and two f32
energies out.
"""
from __future__ import annotations

import math

# Published peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet):
# dense bf16 on the tensor cores, and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

BF16 = 2


def _swiglu(d: int, f: int) -> int:
    return 3 * d * f


def token_macs(cfg: dict) -> dict:
    """Multiply-adds a valid token costs, by part, from the keys of the
    published ``config.json``."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    L, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    f, shared = cfg["moe_intermediate_size"], cfg["n_shared_experts"]
    attn = (d * H * (nope + rope) + d * r + d * rope + r * H * nope
            + r * H * dv + H * dv * d)
    moe = d * E + (k + shared) * _swiglu(d, f)
    return dict(attention=L * attn,
                dense=dense * _swiglu(d, cfg["intermediate_size"]),
                moe=(L - dense) * moe)


def weight_params(cfg: dict) -> int:
    """Parameters a forward reads, less the embedding and the LM head."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    L, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    E, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    shared = cfg["n_shared_experts"]
    attn = (d * H * (nope + rope) + d * (r + rope) + r + r * H * (nope + dv)
            + H * dv * d + 2 * d)                      # with the two norms
    moe = d * E + (E + shared) * _swiglu(d, f)
    return (L * attn + dense * _swiglu(d, cfg["intermediate_size"])
            + (L - dense) * moe + d)                   # the final norm


def batch_work(cfg: dict, lengths, n_literals: int) -> tuple[float, float]:
    """(operations, bytes) of one batch of documents of valid ``lengths``."""
    macs = sum(token_macs(cfg).values())
    H = cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    per_pair = 2 * H * (qk + cfg["v_head_dim"]) * cfg["num_hidden_layers"]
    tokens = sum(lengths)
    flops = (2.0 * macs * tokens
             + per_pair * sum(n * (n + 1) / 2 for n in lengths))
    moved = (weight_params(cfg) * BF16 + tokens * cfg["hidden_size"] * BF16
             + tokens * 8 + len(lengths) * (n_literals + 3 * 4))
    return flops, float(moved)


def bound_s(flops: float, moved: float) -> float:
    """The least time an H100 needs: the larger of the operations over
    the bf16 peak and the bytes over the memory rate."""
    return max(flops / PEAK_BF16_FLOPS, moved / PEAK_HBM_BYTES)


#: Each batch's (operations, least seconds), in pool order, of the pool
#: of the LM cell built last in this process (``record_pool``).
_POOL: list = []


def record_pool(work) -> None:
    """Record a cell's pool: its batches' ``(operations, bytes)``, in
    pool order, as ``batch_work`` gives them."""
    _POOL[:] = [(f, bound_s(f, m)) for f, m in work]


def served(batches: int) -> tuple[float, float] | None:
    """(operations, least seconds) of ``batches`` batches served in pool
    order from the pool's first batch on, as the harness's windows serve
    it; None where no LM cell recorded its pool."""
    if not _POOL:
        return None
    P = len(_POOL)
    picked = [_POOL[k % P] for k in range(batches)]
    return sum(f for f, _ in picked), sum(s for _, s in picked)


def lognormal_lengths(n: int, median: float, sigma: float, lo: int,
                      hi: int) -> list[int]:
    """The ``n`` quantiles (i + 1/2) / n of a lognormal of ``median`` and
    ``sigma``, clipped to [lo, hi] and rounded: the same for every
    seed."""
    import statistics
    nd = statistics.NormalDist()
    return [min(hi, max(lo, round(median * math.exp(
        sigma * nd.inv_cdf((i + 0.5) / n))))) for i in range(n)]

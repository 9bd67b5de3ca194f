"""Feed-forward layers: gated dense MLP and mixture-of-experts (the port
of ``repro.models.ffn``, single-device path).

MoE dispatch is sort-based (no (tokens, E, C) one-hot products): entries
are ranked within their expert by a stable argsort and a running count,
dropped beyond capacity into the drop bin ``E*C``, scatter-added into a
(B, E*C, d) buffer, processed by batched expert matmuls and gathered back.
Compute therefore tracks the active experts (x capacity factor).

Not ported here (it needs a mesh): the reference's expert-parallel
``_routed_ep``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .base import ACTIVATIONS, P, dense
from .config import ModelConfig, MoEConfig


# ---------------------------------------------------------------------------
# Dense gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def decls_mlp(d_model: int, d_ff: int, gated: bool = True) -> dict:
    decls = {
        "w_up": P((d_model, d_ff), ("embed", "mlp")),
        "w_down": P((d_ff, d_model), ("mlp", "embed")),
    }
    if gated:
        decls["w_gate"] = P((d_model, d_ff), ("embed", "mlp"))
    return decls


def mlp_forward(p, x: torch.Tensor, act: str) -> torch.Tensor:
    if "w_gate" in p:
        h = ACTIVATIONS[act](dense(x, p["w_gate"])) * dense(x, p["w_up"])
    else:
        h = ACTIVATIONS[act](dense(x, p["w_up"]))
    return dense(h, p["w_down"])


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------

def decls_moe(cfg: ModelConfig) -> dict:
    moe = cfg.moe
    d, f = cfg.d_model, moe.d_ff_expert
    decls = {
        "router": P((d, moe.n_experts), ("embed", None), scale=0.02),
        "w_gate": P((moe.n_experts, d, f), ("experts", "embed", "moe_mlp")),
        "w_up": P((moe.n_experts, d, f), ("experts", "embed", "moe_mlp")),
        "w_down": P((moe.n_experts, f, d), ("experts", "moe_mlp", "embed")),
    }
    if moe.n_shared:
        decls["shared"] = decls_mlp(d, moe.n_shared * f)
    return decls


def _capacity(tokens_per_group: int, moe: MoEConfig) -> int:
    c = math.ceil(tokens_per_group * moe.top_k * moe.capacity_factor
                  / moe.n_experts)
    return max(min(c, tokens_per_group * moe.top_k), 1)


MOE_GROUP_TOKENS = 4096   # dispatch-group size: bounds the (G,E,C,d) buffers


def moe_forward(p, x: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux load-balance loss scalar).

    Dispatch groups are ``MOE_GROUP_TOKENS``-token sequence slices when S
    is a multiple of it (GShard-style per-group capacity), else the whole
    sequence."""
    B, S, d = x.shape
    G = MOE_GROUP_TOKENS
    if S > G and S % G == 0:
        out, aux = _routed(p, x.reshape(B * (S // G), G, d), cfg)
        out = out.reshape(B, S, d)
    else:
        out, aux = _routed(p, x, cfg)
    if cfg.moe.n_shared:
        out = out + mlp_forward(p["shared"], x, cfg.act)
    return out, aux


def _dispatch_plan(x: torch.Tensor, router: torch.Tensor, moe: MoEConfig):
    """Shared routing math: top-k, capacity ranks, slot ids.

    Returns (probs (B,S,E) f32, top_p, top_e, keep, slot, C) with slot =
    e*C + rank, or E*C (the drop bin) past capacity.  An entry's rank is
    the number of earlier entries (in token-major, then top-k order) routed
    to its expert: a stable argsort of the flat expert ids groups them."""
    B, S, _ = x.shape
    E, K = moe.n_experts, moe.top_k
    C = _capacity(S, moe)
    T = S * K
    logits = dense(x, router)
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    e_flat = top_e.reshape(B, T)
    order = torch.argsort(e_flat, dim=1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    counts = torch.zeros((B, E), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, dim=1) - counts
    rank_sorted = (torch.arange(T, device=x.device)[None, :]
                   - torch.gather(starts, 1, e_sorted))
    inv = torch.argsort(order, dim=1)
    rank = torch.gather(rank_sorted, 1, inv).reshape(B, S, K)
    keep = rank < C
    slot = torch.where(keep, top_e * C + rank, E * C)
    return probs, top_p, top_e, keep, slot, C


def _routed(p, x: torch.Tensor,
            cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    moe = cfg.moe
    B, S, d = x.shape
    E, K = moe.n_experts, moe.top_k
    probs, top_p, top_e, keep, slot, C = _dispatch_plan(x, p["router"], moe)

    # dispatch: scatter tokens into the (B, E*C + drop bin, d) buffer.  A
    # kept slot receives exactly one token, so the adds are exact.
    buf = torch.zeros((B, E * C + 1, d), dtype=x.dtype, device=x.device)
    for j in range(K):
        buf.scatter_add_(1, slot[:, :, j, None].expand(B, S, d),
                         x * keep[:, :, j:j + 1].to(x.dtype))
    buf = buf[:, :E * C].reshape(B, E, C, d)

    # expert FFN, batched over E
    h = (ACTIVATIONS[cfg.act](
            torch.einsum("becd,edf->becf", buf, p["w_gate"].to(x.dtype)))
         * torch.einsum("becd,edf->becf", buf, p["w_up"].to(x.dtype)))
    out_buf = torch.einsum("becf,efd->becd", h, p["w_down"].to(x.dtype))
    out_flat = torch.cat([out_buf.reshape(B, E * C, d),
                          x.new_zeros((B, 1, d))], dim=1)     # drop bin

    # combine: gather own slots, weight by the router probabilities
    out = torch.zeros((B, S, d), dtype=x.dtype, device=x.device)
    for j in range(K):
        gathered = torch.gather(out_flat, 1,
                                slot[:, :, j, None].expand(B, S, d))
        w = (top_p[:, :, j] * keep[:, :, j]).to(x.dtype)
        out = out + gathered * w[:, :, None]

    # aux load-balance loss (Switch/GShard style)
    me = probs.mean(dim=(0, 1))                               # (E,)
    assign = F.one_hot(top_e[..., 0], E).to(torch.float32).mean(dim=(0, 1))
    aux = moe.aux_loss_weight * E * torch.sum(me * assign)
    return out, aux

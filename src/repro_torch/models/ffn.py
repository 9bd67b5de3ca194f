"""Feed-forward layers: gated dense MLP and mixture-of-experts (the port
of ``repro.models.ffn``).

MoE dispatch is sort-based (no (tokens, E, C) one-hot products): entries
are ranked within their expert by a stable argsort and a running count,
dropped beyond capacity into the drop bin ``E*C``, scatter-added into a
(B, E*C, d) buffer, processed by batched expert matmuls and gathered back.
Compute therefore tracks the active experts (x capacity factor).

With ``capacity_factor=None`` (one device, inference) the routing is
dropless (``_routed_dropless``): every (token, expert) pair the router
picks is computed.  The pairs are sorted by expert, the tokens' rows
gathered in that order, and the three expert GEMMs run over the routed
rows grouped by expert (``_grouped_mm``: ``torch._grouped_mm`` with the
groups' ends on the device on a card, so nothing is padded and the
forward never waits on the host), then the outputs are put back in the
pairs' order and weighed in f32, as DeepSeek-V2's ``moe_infer``.  The
router's settings (``norm_topk_prob``, ``router_f32``) hold on both
paths (``_router``).

Spans ``moe.forward`` and ``moe.route`` and the counters ``moe.slots``
(pairs routed), ``moe.rows`` (rows the expert GEMMs computed),
``moe.mean_slots`` (the pairs over the experts), ``moe.max_slots`` (the
heaviest expert's pairs) and ``moe.dropped`` (pairs past capacity)
record in ``repro_torch.tracing`` while it records; the last two are
summed on the device (``tracing.add_device``).

On a mesh (``ctx``, a tensor-parallel model's ``ShardCtx``) the layers
take their input whole over the sequence on every rank of the model axis
and return it at ``("batch", "seq", None)``.  The MLP is column-parallel
(up / gate) and row-parallel (down), its partial sums reduce-scattered.
The MoE dispatch stays group-local on the data shard.  Where the experts
divide the model axis, ``_routed_ep`` (the reference's expert-parallel
``shard_map``): each rank runs its E / model experts, combines the
slots they own, and one reduce of (B, S, d) over the model axis (with
the shared experts' partial sums) completes the output; else
``_routed`` with the expert hidden dim ("moe_mlp") split where it
divides the axis (grok's 8 experts on a 16-wide axis).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import tracing
from .base import ACTIVATIONS, NULL_CTX, P, ShardCtx, dense, model_split
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


def _mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    if "w_gate" in p:
        h = ACTIVATIONS[act](dense(x, p["w_gate"])) * dense(x, p["w_up"])
    else:
        h = ACTIVATIONS[act](dense(x, p["w_up"]))
    return dense(h, p["w_down"])


def mlp_forward(p, x: torch.Tensor, act: str, *,
                ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d).  On a mesh (the reference's
    ``ffn.py:48-50``): column-parallel up / gate and row-parallel down on
    this rank's block of the hidden dim, the partial sums
    reduce-scattered to the sequence shard."""
    return ctx.scatter_seq(_mlp(p, x, act), model_split(p, "w_down", 0))


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


def _ep_sharded(cfg: ModelConfig, ctx: ShardCtx) -> bool:
    """The reference's ``_ep_sharded``: the experts divide the model axis
    (expert parallelism, ``_routed_ep``)."""
    m = ctx.model_size
    return m > 1 and cfg.moe.n_experts % m == 0


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig, *,
                ctx: ShardCtx = NULL_CTX
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux load-balance loss scalar).

    Dispatch groups are ``MOE_GROUP_TOKENS``-token sequence slices when S
    is a multiple of it (GShard-style per-group capacity), else the whole
    sequence.  On a mesh (the reference's ``ffn.py:89-118``): ``_routed_ep``
    where ``_ep_sharded``, else ``_routed``; the routed experts' and the
    shared experts' outputs are added as partial sums over the model axis
    and reduced once to ``("batch", "seq", None)``.  Dropless
    (``capacity_factor=None``) the whole batch is routed at once, on one
    device."""
    with tracing.span("moe.forward"):
        return _moe_forward(p, x, cfg, ctx)


def _moe_forward(p, x: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx):
    B, S, d = x.shape
    G = MOE_GROUP_TOKENS
    routed = _routed_ep if _ep_sharded(cfg, ctx) else _routed
    if cfg.moe.capacity_factor is None:
        if ctx.mesh is not None:
            raise NotImplementedError("dropless routing runs on one device")
        out, aux = _routed_dropless(p, x, cfg)
    elif S > G and S % G == 0:
        out, aux = routed(p, x.reshape(B * (S // G), G, d), cfg, ctx)
        out = out.reshape(B, S, d)
    else:
        out, aux = routed(p, x, cfg, ctx)
    if ctx.mesh is None:
        if cfg.moe.n_shared:
            out = out + _mlp(p["shared"], x, cfg.act)
        return out, aux
    partial = model_split(p, "w_gate", 0) or model_split(p, "w_gate", 2)
    if cfg.moe.n_shared:
        shared = _mlp(p["shared"], x, cfg.act)
        if model_split(p["shared"], "w_down", 0) != partial:
            # the one that every rank holds whole, as a partial sum
            if partial:
                shared = ctx.as_partial(shared)
            else:
                out = ctx.as_partial(out)
            partial = True
        out = out + shared
    return ctx.scatter_seq(out, partial), aux


def _router(x: torch.Tensor, router: torch.Tensor, moe: MoEConfig):
    """(probs (..., E) f32, top-k weights (..., K) f32, top-k experts):
    the softmax of the router's logits (from f32 operands with
    ``router_f32``, else the compute dtype's product), its greedy top-k,
    renormalised with ``norm_topk_prob``."""
    if moe.router_f32:
        logits = x.float() @ router.float()
    else:
        logits = dense(x, router)
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = torch.topk(probs, moe.top_k, dim=-1)
    if moe.norm_topk_prob:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def _dispatch_plan(x: torch.Tensor, router: torch.Tensor, moe: MoEConfig):
    """Shared routing math: top-k (``_router``), capacity ranks, slot ids.

    Returns (probs (B,S,E) f32, top_p, top_e, keep, slot, C) with slot =
    e*C + rank, or E*C (the drop bin) past capacity.  An entry's rank is
    the number of earlier entries (in token-major, then top-k order) routed
    to its expert: a stable argsort of the flat expert ids groups them."""
    B, S, _ = x.shape
    E, K = moe.n_experts, moe.top_k
    C = _capacity(S, moe)
    T = S * K
    probs, top_p, top_e = _router(x, router, moe)
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
    if tracing.recording():
        _count(B * T, B * E * C, E, counts.sum(dim=0), (~keep).sum())
    return probs, top_p, top_e, keep, slot, C


def _count(slots: int, rows: int, E: int, per_expert: torch.Tensor,
           dropped) -> None:
    """One MoE layer's routing counters (``tracing``): pairs routed, rows
    the expert GEMMs computed, the pairs an expert on average, and on
    the device the heaviest expert's pairs and the pairs dropped."""
    tracing.add("moe.slots", slots)
    tracing.add("moe.rows", rows)
    tracing.add("moe.mean_slots", slots / E)
    tracing.add_device("moe.max_slots", per_expert.max())
    if isinstance(dropped, int):
        tracing.add("moe.dropped", dropped)
    else:
        tracing.add_device("moe.dropped", dropped)


def _grouped_mm(a: torch.Tensor, w: torch.Tensor,
                ends: torch.Tensor) -> torch.Tensor:
    """Rows ``a`` (n, k) grouped by expert, group e ending at row
    ``ends[e]`` (int32, on the device), times ``w`` (E, k, f) -> (n, f)
    in ``a``'s dtype, each product accumulated in f32 and rounded once.
    On a card ``torch._grouped_mm`` (the groups' sizes never reach the
    host); elsewhere a loop over the groups."""
    w = w.to(a.dtype)
    if a.is_cuda:
        return torch._grouped_mm(a, w, offs=ends)
    out = a.new_empty((a.shape[0], w.shape[-1]))
    lo = 0
    for e, hi in enumerate(ends.tolist()):
        out[lo:hi] = a[lo:hi] @ w[e]
        lo = hi
    return out


def _routed_dropless(p, x: torch.Tensor, cfg: ModelConfig
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every routed (token, expert) pair computed, on one device, for
    inference: x (B, S, d) -> (the routed experts' weighted sum, a zero
    aux loss).  The pairs, sorted by expert (stable), gather their
    tokens' rows; the expert GEMMs run on the rows grouped by expert; the
    outputs go back to the pairs' order and are weighed and summed over
    the top-k in f32."""
    moe = cfg.moe
    if x.requires_grad or p["w_gate"].requires_grad:
        raise NotImplementedError("dropless routing is for inference; "
                                  "training takes a capacity_factor")
    E, K = moe.n_experts, moe.top_k
    B, S, d = x.shape
    N = B * S
    xt = x.reshape(N, d)
    with tracing.span("moe.route"):
        _, top_p, top_e = _router(xt, p["router"], moe)
        flat = top_e.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.zeros(E, dtype=torch.int32, device=x.device)
        counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
        ends = torch.cumsum(counts, 0, dtype=torch.int32)
        rows = xt.index_select(0, order // K)
    if tracing.recording():
        _count(N * K, N * K, E, counts, 0)
    h = (ACTIVATIONS[cfg.act](_grouped_mm(rows, p["w_gate"], ends))
         * _grouped_mm(rows, p["w_up"], ends))
    ys = _grouped_mm(h, p["w_down"], ends)
    y = torch.empty_like(ys).index_copy_(0, order, ys)
    out = (y.view(N, K, d).float() * top_p[..., None]).sum(dim=1)
    return (out.to(x.dtype).reshape(B, S, d),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _experts(p, buf: torch.Tensor, act: str) -> torch.Tensor:
    """The expert FFN batched over E: buf (B, E, C, d) -> (B, E, C, d)."""
    h = (ACTIVATIONS[act](
            torch.einsum("becd,edf->becf", buf, p["w_gate"].to(buf.dtype)))
         * torch.einsum("becd,edf->becf", buf, p["w_up"].to(buf.dtype)))
    return torch.einsum("becf,efd->becd", h, p["w_down"].to(buf.dtype))


def _dispatch(x: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
              E: int, C: int) -> torch.Tensor:
    """Scatter the tokens into the (B, E, C, d) buffer.  A kept slot
    receives exactly one token, so the adds are exact."""
    B, S, d = x.shape
    buf = torch.zeros((B, E * C + 1, d), dtype=x.dtype, device=x.device)
    for j in range(slot.shape[-1]):
        buf.scatter_add_(1, slot[:, :, j, None].expand(B, S, d),
                         x * keep[:, :, j:j + 1].to(x.dtype))
    return buf[:, :E * C].reshape(B, E, C, d)


def _combine(out_flat: torch.Tensor, slot: torch.Tensor,
             weight: torch.Tensor) -> torch.Tensor:
    """sum_j out_flat[slot_j] * weight_j: out_flat (B, n + 1, d) with the
    drop bin last, slot / weight (B, S, K) -> (B, S, d)."""
    B, S, K = slot.shape
    d = out_flat.shape[-1]
    out = torch.zeros((B, S, d), dtype=out_flat.dtype,
                      device=out_flat.device)
    for j in range(K):
        gathered = torch.gather(out_flat, 1,
                                slot[:, :, j, None].expand(B, S, d))
        out = out + gathered * weight[:, :, j, None].to(out_flat.dtype)
    return out


def _aux(probs: torch.Tensor, top_e: torch.Tensor, moe: MoEConfig,
         mean=lambda t: t) -> torch.Tensor:
    """The Switch / GShard load-balance loss; ``mean`` averages the two
    batch means over the data axes (the reference's global means)."""
    E = moe.n_experts
    me = mean(probs.mean(dim=(0, 1)))                         # (E,)
    assign = mean(F.one_hot(top_e[..., 0], E).to(torch.float32)
                  .mean(dim=(0, 1)))
    return moe.aux_loss_weight * E * torch.sum(me * assign)


def _routed(p, x: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx = NULL_CTX
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """All experts on every rank of the model axis (the reference's
    ``_routed``, ``ffn.py:211``); on a mesh their hidden dim is this rank's block
    where ``"moe_mlp"`` splits it (the output then a partial sum over the
    model axis), and the aux loss's batch means are taken over the data
    axes too, as GSPMD takes them."""
    moe = cfg.moe
    E = moe.n_experts
    probs, top_p, top_e, keep, slot, C = _dispatch_plan(x, p["router"], moe)
    out_buf = _experts(p, _dispatch(x, slot, keep, E, C), cfg.act)
    B, d = x.shape[0], x.shape[-1]
    out_flat = torch.cat([out_buf.reshape(B, E * C, d),
                          x.new_zeros((B, 1, d))], dim=1)     # drop bin
    out = _combine(out_flat, slot, top_p * keep)
    mean = (lambda t: t) if ctx.mesh is None else ctx.mean_data
    return out, _aux(probs, top_e, moe, mean)


def _routed_ep(p, x: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's expert-parallel ``_routed_ep`` (``ffn.py:149``):
    every rank of the model axis routes its data shard's tokens, runs its
    E / model local experts [lo, lo + e_loc) and combines only the slots
    in [lo C, (lo + e_loc) C) -> (a partial sum over the model axis, the
    aux loss averaged over the data axes)."""
    moe = cfg.moe
    E = moe.n_experts
    e_loc = E // ctx.model_size
    lo = ctx.model_rank * e_loc
    probs, top_p, top_e, keep, slot, C = _dispatch_plan(x, p["router"], moe)
    buf = _dispatch(x, slot, keep, E, C)[:, lo:lo + e_loc]
    out_loc = _experts(p, buf, cfg.act)                  # (B, e_loc, C, d)
    B, d = x.shape[0], x.shape[-1]
    out_flat = torch.cat([out_loc.reshape(B, e_loc * C, d),
                          x.new_zeros((B, 1, d))], dim=1)
    mine = (slot >= lo * C) & (slot < (lo + e_loc) * C) & keep
    slot_loc = torch.where(mine, slot - lo * C, e_loc * C)
    out = _combine(out_flat, slot_loc, top_p * mine)
    return out, ctx.mean_data(_aux(probs, top_e, moe))

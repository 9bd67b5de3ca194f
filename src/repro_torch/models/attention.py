"""Attention: GQA (chunked flash-style) and DeepSeek MLA, prefill and
decode (the port of ``repro.models.attention``, single-device path).

Full (S, S) score matrices are never materialized: prefill attention is
a loop over query chunks with an inner online-softmax loop over key
chunks (the flash-attention recurrence in plain PyTorch), so peak logits
memory is (B, H, cq, ck) whatever the sequence length.

Precision, as the reference's: q, k, v, the probabilities and the caches
are rounded to bf16 and contracted with f32 accumulation whatever the
model's dtype (the reference's ``preferred_element_type=f32``).  The port
rounds to bf16 and multiplies in f32: a product of two bf16 values is
exact in f32, and ``import repro_torch`` turns TF32 off, so on the card
these are IEEE f32 GEMMs.

MLA decode uses the "absorbed" formulation: the per-head up-projections
are folded into the query/output so scores are taken directly against the
(B, S, r) compressed KV cache.

Decode writes the new token's entries into the cache in place (the
reference returns an updated copy).

On a mesh (``ctx``, a tensor-parallel model's ``ShardCtx``) the blocks
take their input whole over the sequence (the model all-gathers it
after the norm) and compute on this rank's heads: ``wq`` / ``wk`` /
``wv`` column-parallel, ``wo`` row-parallel, its partial sums
reduce-scattered back to the sequence shard (``ShardCtx.scatter_seq``).
KV heads that do not divide the model axis are whole (``wk`` / ``wv``
are): each rank expands them and takes its query heads' share, and
keeps the cache's head_dim slice.  Heads that do not divide the axis
leave every weight whole: attention then runs context parallel
(``chunked_attention``'s ``_attn_context_parallel`` leg), and a decode
step whose KV heads do not divide it but whose head_dim does takes
``decode_attention``'s head_dim leg.
"""
from __future__ import annotations

import math

import torch

from .. import tracing
from ..sharding.layout import all_gather_axis, all_reduce_axis
from .base import (NULL_CTX, P, ShardCtx, dense, dense_out, model_split,
                   rms_norm)
from .config import ModelConfig
from .rope import apply_rope, mrope_angles, rope_angles, yarn_get_mscale

BF16, F32 = torch.bfloat16, torch.float32


def _bf16_f32(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16, then widen: the operand of an f32-accumulated
    bf16 contraction."""
    return x.to(BF16).to(F32)


# ---------------------------------------------------------------------------
# Parameter declarations
# ---------------------------------------------------------------------------

def decls_gqa(cfg: ModelConfig) -> dict:
    d, hq, hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim)
    decls = {
        "wq": P((d, hq, hd), ("embed", "heads", None)),
        "wk": P((d, hkv, hd), ("embed", "kv", None)),
        "wv": P((d, hkv, hd), ("embed", "kv", None)),
        "wo": P((hq, hd, d), ("heads", None, "embed")),
    }
    if cfg.qk_norm:
        decls["q_gamma"] = P((hd,), (None,), init="zeros")
        decls["k_gamma"] = P((hd,), (None,), init="zeros")
    return decls


def decls_mla(cfg: ModelConfig) -> dict:
    if cfg.mla is None:
        raise ValueError(f"{cfg.name} has no MLA config")
    d, hq, m = cfg.d_model, cfg.n_heads, cfg.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": P((d, hq, qk), ("embed", "heads", None)),
        "w_dkv": P((d, m.kv_lora_rank), ("embed", None)),
        "w_kr": P((d, m.qk_rope_head_dim), ("embed", None)),
        "kv_norm": P((m.kv_lora_rank,), (None,), init="zeros"),
        "w_uk": P((m.kv_lora_rank, hq, m.qk_nope_head_dim),
                  (None, "heads", None)),
        "w_uv": P((m.kv_lora_rank, hq, m.v_head_dim),
                  (None, "heads", None)),
        "wo": P((hq, m.v_head_dim, d), ("heads", None, "embed")),
    }


# ---------------------------------------------------------------------------
# Chunked causal attention (flash-style online softmax)
# ---------------------------------------------------------------------------

def _pad_seq(x: torch.Tensor, length: int) -> torch.Tensor:
    """Zero-pad (or cut) axis 1 to ``length``."""
    pad = length - x.shape[1]
    if pad <= 0:
        return x[:, :length]
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])],
                     dim=1)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      scale: float, q_chunk: int, k_chunk: int,
                      causal: bool = True, q_offset: int = 0,
                      ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, H, Dk/Dv) -> (B, Sq, H, Dv).

    The flash-attention recurrence: over query chunks, an online softmax
    over key chunks.  Callers pre-expand GQA KV heads to H == Hq.  Ragged
    lengths are padded up to the chunk grid; padded key rows sit beyond
    every real query position, so the causal mask kills them.  A row with
    no visible key so far (running max still -inf) is guarded against
    NaN, as in the reference.

    On a mesh whose model axis does not divide H (the reference's
    ``attention.py:104-106``: model > 1, H % model != 0, Sq >= 2 model)
    ``q_chunk`` is clamped to Sq // model, and where the chunk grid then
    divides the axis attention runs context parallel
    (``_attn_context_parallel``, the reference's ``attention.py:186``):
    q, k and v are whole on every rank, each rank takes its block of
    nq / model query chunks through one pass over the key chunks, and the
    output is all-gathered back over the query grid.
    """
    B, Sq, H, _ = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    m = ctx.model_size
    cp = m > 1 and H % m != 0 and Sq >= 2 * m
    if cp:
        q_chunk = min(q_chunk, max(Sq // m, 1))
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    nq, nk = -(-Sq // q_chunk), -(-Sk // k_chunk)
    qp = _bf16_f32(_pad_seq(q, nq * q_chunk))
    kp = _bf16_f32(_pad_seq(k, nk * k_chunk))
    vp = _bf16_f32(_pad_seq(v, nk * k_chunk))
    if cp and nq % m == 0:
        return _attn_context_parallel(qp, kp, vp, scale, q_chunk, k_chunk,
                                      causal, q_offset, ctx)[:, :Sq].to(
                                          q.dtype)
    outs = [_flash_rows(qp[:, qi * q_chunk:(qi + 1) * q_chunk], kp, vp,
                        scale, k_chunk, causal, q_offset + qi * q_chunk)
            for qi in range(nq)]
    out = torch.cat(outs, dim=1).to(q.dtype)
    return out[:, :Sq]


def _flash_rows(qc: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                scale: float, k_chunk: int, causal: bool,
                q_start: int) -> torch.Tensor:
    """Query rows qc (B, cq, H, D) at positions q_start.. through the
    online softmax over every key chunk of kp / vp (f32, padded to the
    key grid) -> (B, cq, H, Dv) f32."""
    B, cq, H, _ = qc.shape
    Dv, nk = vp.shape[-1], kp.shape[1] // k_chunk
    dev = qc.device
    q_iota = torch.arange(cq, device=dev)[:, None]
    k_iota = torch.arange(k_chunk, device=dev)[None, :]
    neg_inf = -math.inf      # a scalar operand: no copy to the card
    m = torch.full((B, H, cq), -math.inf, dtype=F32, device=dev)
    l = torch.zeros((B, H, cq), dtype=F32, device=dev)
    acc = torch.zeros((B, H, cq, Dv), dtype=F32, device=dev)
    for ki in range(nk):
        kc = kp[:, ki * k_chunk:(ki + 1) * k_chunk]
        vc = vp[:, ki * k_chunk:(ki + 1) * k_chunk]
        logits = torch.einsum("bqhd,bkhd->bhqk", qc, kc) * scale
        if causal:
            qpos = q_start + q_iota
            kpos = ki * k_chunk + k_iota
            logits = torch.where(qpos >= kpos, logits, neg_inf)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(logits - m_safe[..., None])
        corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                     neg_inf))
        l = l * corr + p.sum(dim=-1)
        acc = (acc * corr[..., None]
               + torch.einsum("bhqk,bkhd->bhqd", _bf16_f32(p), vc))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]         # (B,H,cq,Dv)
    return out.transpose(1, 2)                               # (B,cq,H,Dv)


def _attn_context_parallel(qp, kp, vp, scale: float, q_chunk: int,
                           k_chunk: int, causal: bool, q_offset: int,
                           ctx: ShardCtx) -> torch.Tensor:
    """The reference's ``_attn_context_parallel``: the query-chunk grid
    is split over the model axis, this rank's nq / model chunks advance
    together through one pass over the key chunks (K/V whole on every
    rank), and the outputs are all-gathered back over the grid ->
    (B, nq q_chunk, H, Dv) f32 on every rank of the model axis."""
    rows = qp.shape[1] // ctx.model_size
    lo = ctx.model_rank * rows
    mine = _flash_rows(qp[:, lo:lo + rows], kp, vp, scale, k_chunk, causal,
                       q_offset + lo)
    return all_gather_axis(mine, ctx.mesh, "model", 1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor | None,
                     *, scale: float, ctx: ShardCtx = NULL_CTX,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """One-token attention against a KV cache.

    q (B, 1, Hq, D); caches (B, Smax, Hkv, D); cache_len () or (B,) —
    number of valid cache entries INCLUDING the current token; entries at
    and beyond it are masked to -inf.  A ring cache (zamba2's) passes
    ``valid`` (B, Smax), its mask of valid slots, in place of
    ``cache_len``.

    On a mesh whose model axis divides the head_dim but not Hkv (the
    reference's ``shard_map`` leg, ``attention.py:258-291``) each rank
    takes its head_dim slice of q and of the caches (the caches may come
    whole or as that slice, the layout ``cache_axes`` gives), computes
    partial logits, and one all-reduce of (B, Hkv, G, Smax) over the model
    axis completes them; the output, each rank's head_dim slice, is
    all-gathered to (B, 1, Hq, Dv) on every rank.  The batch is the rows
    the caller holds (whole on every data rank where it does not divide
    the data axes, as ``prefill_axes`` lays it out).
    """
    B, _, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    m = ctx.model_size
    leg = m > 1 and Hkv % m != 0 and D % m == 0
    if leg:
        r, w = ctx.model_rank, D // m
        q = q.narrow(-1, r * w, w)
        if k_cache.shape[-1] == D:
            k_cache = k_cache.narrow(-1, r * w, w)
        if v_cache.shape[-1] == D:
            v_cache = v_cache.narrow(-1, r * w, w)
    qg = _bf16_f32(q.reshape(B, Hkv, Hq // Hkv, q.shape[-1]))
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, _bf16_f32(k_cache)) * scale
    if leg:
        logits = all_reduce_axis(logits, ctx.mesh, "model")
    if valid is None:
        pos = torch.arange(Smax, device=q.device)[None, :]
        valid = pos < cache_len.reshape(-1, 1)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.tensor(-math.inf, dtype=F32, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", _bf16_f32(p), _bf16_f32(v_cache))
    out = out.reshape(B, 1, Hq, v_cache.shape[-1]).to(q.dtype)
    if leg:
        out = all_gather_axis(out, ctx.mesh, "model", 3)
    return out


def _write_slot(cache: torch.Tensor, upd: torch.Tensor,
                idx: torch.Tensor) -> None:
    """cache[b, idx[b]] = upd[b, 0] in place; the index clamps to the last
    slot, as the reference's ``dynamic_update_slice`` does."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, idx.long().clamp(0, cache.shape[1] - 1)] = \
        upd[:, 0].to(cache.dtype)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def _angles(cfg: ModelConfig, positions: torch.Tensor,
            head_dim: int) -> torch.Tensor:
    if cfg.rope_scaling is not None:
        raise NotImplementedError("YaRN rope scaling is implemented for "
                                  "MLA (DeepSeek-V2) only")
    if cfg.rope_style == "mrope":
        return mrope_angles(positions, head_dim, cfg.rope_theta,
                            cfg.mrope_sections)
    return rope_angles(positions, head_dim, cfg.rope_theta)


def _cache_block(t: torch.Tensor, ctx: ShardCtx, taken: bool
                 ) -> torch.Tensor:
    """This rank's block of a cache leaf computed whole over its last dim
    (``cache_axes``' ``"head_dim"``, which takes the model axis where no
    earlier dim (``taken``) does and it divides the dim)."""
    if taken or not ctx.shards(t.shape[-1], "head_dim"):
        return t
    w = t.shape[-1] // ctx.model_size
    return t.narrow(-1, ctx.model_rank * w, w).contiguous()


def _whole_cache(t: torch.Tensor, ctx: ShardCtx, full: int) -> torch.Tensor:
    """A cache leaf whole over its last dim (of ``full``): all-gathered
    where this rank holds a slice of it."""
    if t.shape[-1] == full:
        return t
    return all_gather_axis(t, ctx.mesh, "model", t.ndim - 1)


def gqa_forward(p, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, ctx: ShardCtx = NULL_CTX,
                cache: dict | None = None,
                fill_len: int | None = None) -> tuple:
    """x (B, S, d) -> (out (B, S, d), the layer's cache or None).

    ``positions`` is (B, S) int, or (3, B, S) for M-RoPE.  With ``cache``
    set, S must be 1 (decode) and the cache dict holds {"k": (B, Smax,
    Hkv, D), "v": ..., "len": (B,)} — "len" counts tokens already in the
    cache BEFORE this call; the new entries are written in place and the
    returned dict holds the same buffers and ``len + 1``.  With
    ``fill_len`` set (prefill), the full-sequence K/V (bf16) are padded to
    that length and returned as a fresh cache.

    On a mesh (the reference's ``attention.py:337-377`` and its
    constraint points): ``x`` is whole over the sequence on every rank of
    the model axis, the weights are this rank's blocks (``p.specs``), the
    output is at ``("batch", "seq", None)`` (``ShardCtx.scatter_seq``)
    and the cache is this rank's block under ``cache_axes``.
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)
    heads, kv = model_split(p, "wq", 1), model_split(p, "wk", 1)

    q = dense(x, p["wq"])
    k = dense(x, p["wk"])
    v = dense(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_gamma"])
        k = rms_norm(k, p["k_gamma"])
    if cfg.rope_style != "none":
        ang = _angles(cfg, positions, hd)
        q = apply_rope(q, ang)
        k = apply_rope(k, ang)
    hq = q.shape[2]
    mine = lambda t: t.narrow(2, ctx.model_rank * hq, hq)

    if cache is None:
        g = cfg.n_heads // cfg.n_kv_heads
        k_full = torch.repeat_interleave(k, g, dim=2) if g > 1 else k
        v_full = torch.repeat_interleave(v, g, dim=2) if g > 1 else v
        if heads and not kv:      # whole KV heads: my query heads' share
            k_full, v_full = mine(k_full), mine(v_full)
        out = chunked_attention(q, k_full, v_full, scale=scale,
                                q_chunk=min(cfg.attn_chunk_q, S),
                                k_chunk=min(cfg.attn_chunk_k, S),
                                ctx=NULL_CTX if heads else ctx)
        new_cache = None
        if fill_len is not None:
            new_cache = dict(
                k=_pad_seq(_cache_block(k, ctx, kv).to(BF16), fill_len),
                v=_pad_seq(_cache_block(v, ctx, kv).to(BF16), fill_len),
                len=torch.full((B,), S, dtype=torch.int32, device=x.device))
    else:
        idx = cache["len"]
        _write_slot(cache["k"], _cache_block(k, ctx, kv), idx)
        _write_slot(cache["v"], _cache_block(v, ctx, kv), idx)
        if kv or ctx.mesh is None:
            out = decode_attention(q, cache["k"], cache["v"], idx + 1,
                                   scale=scale)
        else:                     # whole KV heads: every query head
            qa = all_gather_axis(q, ctx.mesh, "model", 2) if heads else q
            out = decode_attention(qa, cache["k"], cache["v"], idx + 1,
                                   scale=scale, ctx=ctx)
            if heads:
                out = mine(out)
        new_cache = dict(k=cache["k"], v=cache["v"], len=idx + 1)
    return ctx.scatter_seq(dense_out(out, p["wo"]), heads), new_cache


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_forward(p, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, ctx: ShardCtx = NULL_CTX,
                cache: dict | None = None,
                fill_len: int | None = None) -> tuple:
    """Multi-head latent attention (``_mla``) under the span
    ``mla.forward`` (``tracing``)."""
    with tracing.span("mla.forward"):
        return _mla(p, x, positions, cfg, ctx=ctx, cache=cache,
                    fill_len=fill_len)


def _mla(p, x: torch.Tensor, positions: torch.Tensor,
         cfg: ModelConfig, *, ctx: ShardCtx = NULL_CTX,
         cache: dict | None = None,
         fill_len: int | None = None) -> tuple:
    """Multi-head latent attention; the cache holds the COMPRESSED kv
    stream: {"ckv": (B, Smax, r), "kr": (B, Smax, rope_dim), "len": (B,)}.

    On a mesh (the reference's ``attention.py:396-449``) as
    ``gqa_forward``: ``wq``, ``w_uk``, ``w_uv`` and ``wo`` are this rank's
    heads, ``w_dkv`` / ``w_kr`` whole; the caches hold this rank's slice
    of their last dim (``cache_axes``' ``"head_dim"``) and a decode step
    all-gathers them before use.

    With ``cfg.rope_scaling`` (YaRN) the rope angles are YaRN's and the
    softmax scale is multiplied by ``yarn_get_mscale(factor,
    mscale_all_dim) ** 2``, in the prefill and the absorbed decode alike
    (DeepSeek-V2's ``DeepseekV2Attention``)."""
    m = cfg.mla
    B, S, _ = x.shape
    nope, rdim = m.qk_nope_head_dim, m.qk_rope_head_dim
    scale = 1.0 / math.sqrt(nope + rdim)
    yarn = cfg.rope_scaling
    if yarn is not None and yarn.mscale_all_dim:
        scale *= yarn_get_mscale(yarn.factor, yarn.mscale_all_dim) ** 2
    heads = model_split(p, "wq", 1)

    q = dense(x, p["wq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv = rms_norm(dense(x, p["w_dkv"]), p["kv_norm"])       # (B, S, r)
    kr = dense(x, p["w_kr"])                                 # (B, S, rdim)

    ang = rope_angles(positions, rdim, cfg.rope_theta, yarn)
    q_rope = apply_rope(q_rope, ang)
    kr = apply_rope(kr[:, :, None, :], ang)[:, :, 0, :]      # one shared head
    hq = q.shape[2]

    if cache is None:
        k_nope = dense(ckv, p["w_uk"])                       # (B,S,H,nope)
        v = dense(ckv, p["w_uv"])
        k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, hq, rdim)],
                      dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        out = chunked_attention(qf, k, v, scale=scale,
                                q_chunk=min(cfg.attn_chunk_q, S),
                                k_chunk=min(cfg.attn_chunk_k, S),
                                ctx=NULL_CTX if heads else ctx)
        new_cache = None
        if fill_len is not None:
            new_cache = dict(
                ckv=_pad_seq(_cache_block(ckv, ctx, False).to(BF16),
                             fill_len),
                kr=_pad_seq(_cache_block(kr, ctx, False).to(BF16), fill_len),
                len=torch.full((B,), S, dtype=torch.int32, device=x.device))
    else:
        # Absorbed decode: fold w_uk into q, w_uv into the output.
        idx = cache["len"]
        _write_slot(cache["ckv"], _cache_block(ckv, ctx, False), idx)
        _write_slot(cache["kr"], _cache_block(kr, ctx, False), idx)
        ckv_c = _whole_cache(cache["ckv"], ctx, m.kv_lora_rank).to(x.dtype)
        kr_c = _whole_cache(cache["kr"], ctx, rdim).to(x.dtype)
        q_abs = torch.einsum("bshk,rhk->bshr", q_nope,
                             p["w_uk"].to(x.dtype))          # (B,1,H,r)
        logits = (torch.einsum("bshr,btr->bhst", q_abs.float(),
                               ckv_c.float())
                  + torch.einsum("bshk,btk->bhst", q_rope.float(),
                                 kr_c.float())) * scale
        Smax = ckv_c.shape[1]
        pos = torch.arange(Smax, device=x.device)[None, :]
        valid = pos < (idx + 1)[:, None]
        logits = torch.where(valid[:, None, None, :], logits,
                             torch.tensor(-math.inf, dtype=F32,
                                          device=x.device))
        pr = torch.softmax(logits, dim=-1)
        o_r = torch.einsum("bhst,btr->bshr", pr.to(x.dtype), ckv_c)
        out = torch.einsum("bshr,rhk->bshk", o_r, p["w_uv"].to(x.dtype))
        new_cache = dict(ckv=cache["ckv"], kr=cache["kr"], len=idx + 1)
    return ctx.scatter_seq(dense_out(out, p["wo"]), heads), new_cache


def attn_decls(cfg: ModelConfig) -> dict:
    return decls_mla(cfg) if cfg.mla is not None else decls_gqa(cfg)


def attn_forward(p, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, *, ctx: ShardCtx = NULL_CTX,
                 cache: dict | None = None,
                 fill_len: int | None = None) -> tuple:
    """``mla_forward`` or ``gqa_forward`` by the config (the reference's
    ``attention.py:456``), on ``ctx``'s mesh where it has one."""
    fn = mla_forward if cfg.mla is not None else gqa_forward
    return fn(p, x, positions, cfg, ctx=ctx, cache=cache, fill_len=fill_len)


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dtype: torch.dtype = BF16,
                    device: torch.device | str | None = None,
                    ctx: ShardCtx = NULL_CTX, axes: dict | None = None
                    ) -> dict:
    """One layer's empty cache (of ``batch`` rows); on a mesh, this rank's
    block under ``axes`` (one layer's ``cache_axes``, the reference's
    ``transformer.py:246-270``) over the model axis."""
    if cfg.mla is not None:
        m = cfg.mla
        shapes = dict(ckv=(batch, max_len, m.kv_lora_rank),
                      kr=(batch, max_len, m.qk_rope_head_dim))
    else:
        hd = cfg.resolved_head_dim
        shapes = dict(k=(batch, max_len, cfg.n_kv_heads, hd),
                      v=(batch, max_len, cfg.n_kv_heads, hd))
    out = {}
    for k, shape in shapes.items():
        if ctx.mesh is not None:
            shape = ctx.model_block(shape, axes[k])
        out[k] = torch.zeros(shape, dtype=dtype, device=device)
    out["len"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return out

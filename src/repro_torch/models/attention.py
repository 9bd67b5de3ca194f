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

Not ported here (they need a mesh): the reference's context-parallel
branch of ``chunked_attention`` and the ``shard_map`` leg of
``decode_attention``.
"""
from __future__ import annotations

import math

import torch

from .base import P, dense, dense_out, rms_norm
from .config import ModelConfig
from .rope import apply_rope, mrope_angles, rope_angles

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
                      causal: bool = True, q_offset: int = 0
                      ) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, H, Dk/Dv) -> (B, Sq, H, Dv).

    The flash-attention recurrence: over query chunks, an online softmax
    over key chunks.  Callers pre-expand GQA KV heads to H == Hq.  Ragged
    lengths are padded up to the chunk grid; padded key rows sit beyond
    every real query position, so the causal mask kills them.  A row with
    no visible key so far (running max still -inf) is guarded against
    NaN, as in the reference.
    """
    B, Sq, H, _ = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    nq, nk = -(-Sq // q_chunk), -(-Sk // k_chunk)
    qp = _bf16_f32(_pad_seq(q, nq * q_chunk))
    kp = _bf16_f32(_pad_seq(k, nk * k_chunk))
    vp = _bf16_f32(_pad_seq(v, nk * k_chunk))
    dev = q.device
    q_iota = torch.arange(q_chunk, device=dev)[:, None]
    k_iota = torch.arange(k_chunk, device=dev)[None, :]
    neg_inf = torch.tensor(-math.inf, dtype=F32, device=dev)

    outs = []
    for qi in range(nq):
        qc = qp[:, qi * q_chunk:(qi + 1) * q_chunk]          # (B,cq,H,D)
        m = torch.full((B, H, q_chunk), -math.inf, dtype=F32, device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=F32, device=dev)
        acc = torch.zeros((B, H, q_chunk, Dv), dtype=F32, device=dev)
        for ki in range(nk):
            kc = kp[:, ki * k_chunk:(ki + 1) * k_chunk]
            vc = vp[:, ki * k_chunk:(ki + 1) * k_chunk]
            logits = torch.einsum("bqhd,bkhd->bhqk", qc, kc) * scale
            if causal:
                qpos = q_offset + qi * q_chunk + q_iota
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
        out = acc / torch.clamp(l, min=1e-30)[..., None]     # (B,H,cq,Dv)
        outs.append(out.transpose(1, 2))                     # (B,cq,H,Dv)
    out = torch.cat(outs, dim=1).to(q.dtype)
    return out[:, :Sq]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     scale: float) -> torch.Tensor:
    """One-token attention against a KV cache.

    q (B, 1, Hq, D); caches (B, Smax, Hkv, D); cache_len () or (B,) —
    number of valid cache entries INCLUDING the current token; entries at
    and beyond it are masked to -inf.
    """
    B, _, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = _bf16_f32(q.reshape(B, Hkv, Hq // Hkv, D))
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, _bf16_f32(k_cache)) * scale
    pos = torch.arange(Smax, device=q.device)[None, :]
    valid = pos < cache_len.reshape(-1, 1)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.tensor(-math.inf, dtype=F32, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", _bf16_f32(p), _bf16_f32(v_cache))
    return out.reshape(B, 1, Hq, v_cache.shape[-1]).to(q.dtype)


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
    if cfg.rope_style == "mrope":
        return mrope_angles(positions, head_dim, cfg.rope_theta,
                            cfg.mrope_sections)
    return rope_angles(positions, head_dim, cfg.rope_theta)


def gqa_forward(p, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, cache: dict | None = None,
                fill_len: int | None = None) -> tuple:
    """x (B, S, d) -> (out (B, S, d), the layer's cache or None).

    ``positions`` is (B, S) int, or (3, B, S) for M-RoPE.  With ``cache``
    set, S must be 1 (decode) and the cache dict holds {"k": (B, Smax,
    Hkv, D), "v": ..., "len": (B,)} — "len" counts tokens already in the
    cache BEFORE this call; the new entries are written in place and the
    returned dict holds the same buffers and ``len + 1``.  With
    ``fill_len`` set (prefill), the full-sequence K/V (bf16) are padded to
    that length and returned as a fresh cache.
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)

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

    if cache is None:
        g = cfg.n_heads // cfg.n_kv_heads
        k_full = torch.repeat_interleave(k, g, dim=2) if g > 1 else k
        v_full = torch.repeat_interleave(v, g, dim=2) if g > 1 else v
        out = chunked_attention(q, k_full, v_full, scale=scale,
                                q_chunk=min(cfg.attn_chunk_q, S),
                                k_chunk=min(cfg.attn_chunk_k, S))
        new_cache = None
        if fill_len is not None:
            new_cache = dict(
                k=_pad_seq(k.to(BF16), fill_len),
                v=_pad_seq(v.to(BF16), fill_len),
                len=torch.full((B,), S, dtype=torch.int32, device=x.device))
    else:
        idx = cache["len"]
        _write_slot(cache["k"], k, idx)
        _write_slot(cache["v"], v, idx)
        out = decode_attention(q, cache["k"], cache["v"], idx + 1,
                               scale=scale)
        new_cache = dict(k=cache["k"], v=cache["v"], len=idx + 1)
    return dense_out(out, p["wo"]), new_cache


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_forward(p, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, cache: dict | None = None,
                fill_len: int | None = None) -> tuple:
    """Multi-head latent attention; the cache holds the COMPRESSED kv
    stream: {"ckv": (B, Smax, r), "kr": (B, Smax, rope_dim), "len": (B,)}."""
    m = cfg.mla
    B, S, _ = x.shape
    hq = cfg.n_heads
    nope, rdim = m.qk_nope_head_dim, m.qk_rope_head_dim
    scale = 1.0 / math.sqrt(nope + rdim)

    q = dense(x, p["wq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv = rms_norm(dense(x, p["w_dkv"]), p["kv_norm"])       # (B, S, r)
    kr = dense(x, p["w_kr"])                                 # (B, S, rdim)

    ang = rope_angles(positions, rdim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, ang)
    kr = apply_rope(kr[:, :, None, :], ang)[:, :, 0, :]      # one shared head

    if cache is None:
        k_nope = dense(ckv, p["w_uk"])                       # (B,S,H,nope)
        v = dense(ckv, p["w_uv"])
        k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, hq, rdim)],
                      dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        out = chunked_attention(qf, k, v, scale=scale,
                                q_chunk=min(cfg.attn_chunk_q, S),
                                k_chunk=min(cfg.attn_chunk_k, S))
        new_cache = None
        if fill_len is not None:
            new_cache = dict(
                ckv=_pad_seq(ckv.to(BF16), fill_len),
                kr=_pad_seq(kr.to(BF16), fill_len),
                len=torch.full((B,), S, dtype=torch.int32, device=x.device))
    else:
        # Absorbed decode: fold w_uk into q, w_uv into the output.
        idx = cache["len"]
        _write_slot(cache["ckv"], ckv, idx)
        _write_slot(cache["kr"], kr, idx)
        ckv_c = cache["ckv"].to(x.dtype)
        kr_c = cache["kr"].to(x.dtype)
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
    return dense_out(out, p["wo"]), new_cache


def attn_decls(cfg: ModelConfig) -> dict:
    return decls_mla(cfg) if cfg.mla is not None else decls_gqa(cfg)


def attn_forward(p, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, *, cache: dict | None = None,
                 fill_len: int | None = None) -> tuple:
    fn = mla_forward if cfg.mla is not None else gqa_forward
    return fn(p, x, positions, cfg, cache=cache, fill_len=fill_len)


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dtype: torch.dtype = BF16,
                    device: torch.device | str | None = None) -> dict:
    """One layer's empty cache."""
    if cfg.mla is not None:
        m = cfg.mla
        return dict(
            ckv=torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                            device=device),
            kr=torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype,
                           device=device),
            len=torch.zeros((batch,), dtype=torch.int32, device=device))
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.n_kv_heads, hd)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device),
                len=torch.zeros((batch,), dtype=torch.int32, device=device))

"""Mamba2 (SSD) block, the recurrent core of the Zamba2 hybrid (the port
of ``repro.models.mamba2``).

Per arXiv:2405.21060 / Zamba2 (arXiv:2411.15242): a fused in_proj
producing (z gate | x | B | C | dt), a short causal depthwise conv over
(x, B, C), a per-head scalar decay ``a_t = exp(-exp(A_log) * dt_t)``, the
SSD recurrence ``S_t = a_t S_{t-1} + (dt_t x_t) (x) B_t``, ``y_t = C_t .
S_t`` + D-skip, a gated RMSNorm and out_proj.  The recurrence runs on
``ssm_common.chunked_la`` (inclusive diagonal, the scalar decay broadcast
over the state channel axis) for prefill and ``la_step`` for decode.

Precision, as the reference's: the projections, the conv, the D-skip and
the gated norm run in the compute dtype; softplus of ``dt + dt_bias``, the
decay and the recurrence in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import P, dense, rms_norm, silu
from .config import ModelConfig
from .ssm_common import chunked_la, la_step


def mamba_dims(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.state_dim
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.state_dim + n_heads
    return dict(d_inner=d_inner, n_heads=n_heads, conv_ch=conv_ch,
                d_in_proj=d_in_proj)


def decls_mamba(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    dims = mamba_dims(cfg)
    d = cfg.d_model
    return {
        "in_proj": P((d, dims["d_in_proj"]), ("embed", "mlp")),
        "conv_w": P((s.conv_width, dims["conv_ch"]), (None, "mlp"),
                    init="small"),
        "conv_b": P((dims["conv_ch"],), ("mlp",), init="zeros"),
        "dt_bias": P((dims["n_heads"],), ("heads",), init="zeros"),
        "a_log": P((dims["n_heads"],), ("heads",), init="zeros"),
        "d_skip": P((dims["n_heads"],), ("heads",), init="ones"),
        "norm": P((dims["d_inner"],), ("mlp",), init="zeros"),
        "out_proj": P((dims["d_inner"], d), ("mlp", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by shifted adds in x's dtype, in the
    reference's order (``w[-1]`` first, then taps 0..W-2, then the bias,
    each add rounded).  x (B, S, C); w (W, C)."""
    W = w.shape[0]
    S = x.shape[1]
    out = x * w[-1].to(x.dtype)
    for j in range(W - 1):
        shift = W - 1 - j
        shifted = torch.cat([x.new_zeros((x.shape[0], shift, x.shape[2])),
                             x], dim=1)[:, :S]
        out = out + shifted * w[j].to(x.dtype)
    return out + b.to(x.dtype)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s = cfg.ssm
    dims = mamba_dims(cfg)
    di, gN = dims["d_inner"], s.n_groups * s.state_dim
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + dims["conv_ch"]]
    dt = zxbcdt[..., di + dims["conv_ch"]:]
    return z, xbc, dt, di, gN


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig, *,
                  state: dict | None = None) -> tuple[torch.Tensor, dict]:
    """x (B, S, d) -> (out (B, S, d), the state for decode).

    Prefill (``state=None``) returns {"conv": the last W-1 conv inputs
    (B, W-1, conv_ch), left-padded with zeros when S < W-1, "s": (B, H,
    N, P) f32}; decode (S == 1) reads such a state and returns the next
    one (fresh tensors: the caller writes them where it keeps them).
    """
    s = cfg.ssm
    dims = mamba_dims(cfg)
    B, S, _ = x.shape
    H, Pd, N, G = dims["n_heads"], s.head_dim, s.state_dim, s.n_groups

    zxbcdt = dense(x, p["in_proj"])
    z, xbc, dt, di, gN = _split_proj(cfg, zxbcdt)

    new_state: dict = {}
    if state is None:
        # Carry the conv tail so a prefill can hand off to decode (a copy:
        # a view would keep the whole (B, S, d_in_proj) projection alive).
        tail = xbc[:, -(s.conv_width - 1):].clone()
        pad = s.conv_width - 1 - tail.shape[1]
        if pad > 0:
            tail = torch.cat([tail.new_zeros((B, pad, tail.shape[2])),
                              tail], dim=1)
        new_state["conv"] = tail
        xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    else:
        window = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)
        # einsum("bwc,wc->bc") in xbc's dtype: exact products, an f32
        # sum, one rounding (the reference's dot).
        conv = (window.float() * p["conv_w"].to(xbc.dtype).float()).sum(1)
        xbc = (conv.to(xbc.dtype) + p["conv_b"].to(xbc.dtype))[:, None]
        new_state["conv"] = window[:, 1:]
    xbc = silu(xbc)

    xs = xbc[..., :di].reshape(B, S, H, Pd)
    rep = H // G                  # groups are contiguous blocks of heads
    Bm = xbc[..., di:di + gN].reshape(B, S, G, N).repeat_interleave(rep, 2)
    Cm = xbc[..., di + gN:].reshape(B, S, G, N).repeat_interleave(rep, 2)

    dt = F.softplus(dt.float() + p["dt_bias"].float())        # (B,S,H)
    log_a = -torch.exp(p["a_log"].float()) * dt               # <= 0
    v = xs * dt[..., None].to(xs.dtype)                       # (B,S,H,P)
    log_w = log_a[..., None].expand(B, S, H, N)

    if state is None:
        y, new_state["s"] = chunked_la(Cm, Bm, v, log_w, inclusive=True,
                                       chunk=s.chunk)
    else:
        y1, new_state["s"] = la_step(state["s"], Cm[:, 0], Bm[:, 0],
                                     v[:, 0], log_w[:, 0], inclusive=True)
        y = y1[:, None]

    y = y + xs * p["d_skip"].to(xs.dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    y = rms_norm(y, p["norm"]) * silu(z)
    return dense(y, p["out_proj"]), new_state


def init_mamba_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: torch.device | str | None = None) -> dict:
    s = cfg.ssm
    dims = mamba_dims(cfg)
    return dict(
        conv=torch.zeros((batch, s.conv_width - 1, dims["conv_ch"]),
                         dtype=dtype, device=device),
        s=torch.zeros((batch, dims["n_heads"], s.state_dim, s.head_dim),
                      dtype=torch.float32, device=device))

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

On a mesh (``ctx``, a tensor-parallel model's ``ShardCtx``; the
reference's constraint points ``mamba2.py:86,133,135``) the block takes
its input whole over the sequence and returns its output at the layer
boundary's layout.  ``in_proj``, ``conv_w`` / ``conv_b`` are split in
even blocks of the fused ``z | x | B | C | dt`` width, which are not
aligned with the heads (zamba2-7b's 14704-wide ``in_proj`` on 4 ranks is
3676 columns a rank); the activations move instead of the weights:
``in_proj`` runs column-parallel and its output is all-gathered, each
rank convolves the columns of its own conv block (the conv is per
channel) and the conv output is all-gathered, then each rank takes its
heads' ``x`` and ``dt`` and its heads' groups' ``B`` / ``C`` and runs
the recurrence on its heads.  The gated RMSNorm all-reduces its f32 sum
of squares over the model axis, and ``out_proj`` runs row-parallel, its
partial sums reduce-scattered (``ShardCtx.scatter_seq``).  A dim that
does not divide the model axis is whole, and that part is computed
whole on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..numerics import rsqrt_rn
from ..sharding.layout import all_gather_axis, all_reduce_axis
from .base import NULL_CTX, P, ShardCtx, dense, model_split, rms_norm, silu
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


def _whole(t: torch.Tensor, split: bool, ctx: ShardCtx) -> torch.Tensor:
    """``t`` whole over its last dim: all-gathered over the model axis
    where ``split`` (``t`` is this rank's even block of it)."""
    return all_gather_axis(t, ctx.mesh, "model", t.ndim - 1) if split else t


def _mine(t: torch.Tensor, split: bool, ctx: ShardCtx,
          dim: int = -1) -> torch.Tensor:
    """This rank's even block of ``t`` along ``dim`` where ``split``
    (a tensor every model rank holds whole), else ``t``."""
    if not split:
        return t
    n = t.shape[dim] // ctx.model_size
    return t.narrow(dim, ctx.model_rank * n, n)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, gamma: torch.Tensor,
                ctx: ShardCtx, split: bool) -> torch.Tensor:
    """``rms_norm(y, gamma) * silu(z)`` over d_inner; where ``split``,
    ``y`` / ``z`` / ``gamma`` are this rank's block of it and the f32 sum
    of squares is all-reduced over the model axis."""
    if not split:
        return rms_norm(y, gamma) * silu(z)
    ss = all_reduce_axis(y.float().square().sum(dim=-1, keepdim=True),
                         ctx.mesh, "model")
    inv = rsqrt_rn(ss / (y.shape[-1] * ctx.model_size) + 1e-6)
    return y * inv.to(y.dtype) * (1.0 + gamma.to(y.dtype)) * silu(z)


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig, *,
                  ctx: ShardCtx = NULL_CTX,
                  state: dict | None = None) -> tuple[torch.Tensor, dict]:
    """x (B, S, d) -> (out (B, S, d), the state for decode).

    Prefill (``state=None``) returns {"conv": the last W-1 conv inputs
    (B, W-1, conv_ch), left-padded with zeros when S < W-1, "s": (B, H,
    N, P) f32}; decode (S == 1) reads such a state and returns the next
    one (fresh tensors: the caller writes them where it keeps them).

    On a mesh (module docstring) ``x`` is whole over the sequence, the
    weights are this rank's blocks (``p.specs``), the output is at
    ``("batch", "seq", None)`` and the state is this rank's block under
    ``cache_axes`` (``conv`` its conv block's channels, ``s`` its
    heads).
    """
    s = cfg.ssm
    dims = mamba_dims(cfg)
    B, S, _ = x.shape
    H, Pd, N, G = dims["n_heads"], s.head_dim, s.state_dim, s.n_groups
    conv = model_split(p, "conv_w", 1)
    heads = model_split(p, "dt_bias", 0)
    inner = model_split(p, "out_proj", 0)       # "mlp" over d_inner

    zxbcdt = _whole(dense(x, p["in_proj"]), model_split(p, "in_proj", 1),
                    ctx)
    z, xbc, dt, di, gN = _split_proj(cfg, zxbcdt)
    xbc = _mine(xbc, conv, ctx)

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
        conv_out = (window.float()
                    * p["conv_w"].to(xbc.dtype).float()).sum(1)
        xbc = (conv_out.to(xbc.dtype) + p["conv_b"].to(xbc.dtype))[:, None]
        new_state["conv"] = window[:, 1:]
    xbc = _whole(silu(xbc), conv, ctx)

    # this rank's h heads (all H where "heads" is whole)
    xs = _mine(xbc[..., :di], heads, ctx)
    h = xs.shape[-1] // Pd
    xs = xs.reshape(B, S, h, Pd)
    rep = H // G                  # groups are contiguous blocks of heads
    Bm, Cm = (_mine(xbc[..., lo:lo + gN].reshape(B, S, G, N)
                    .repeat_interleave(rep, 2), heads, ctx, 2)
              for lo in (di, di + gN))
    dt = _mine(dt, heads, ctx)

    dt = F.softplus(dt.float() + p["dt_bias"].float())        # (B,S,h)
    log_a = -torch.exp(p["a_log"].float()) * dt               # <= 0
    v = xs * dt[..., None].to(xs.dtype)                       # (B,S,h,P)
    log_w = log_a[..., None].expand(B, S, h, N)

    if state is None:
        y, new_state["s"] = chunked_la(Cm, Bm, v, log_w, inclusive=True,
                                       chunk=s.chunk)
    else:
        y1, new_state["s"] = la_step(state["s"], Cm[:, 0], Bm[:, 0],
                                     v[:, 0], log_w[:, 0], inclusive=True)
        y = y1[:, None]

    y = y + xs * p["d_skip"].to(xs.dtype)[None, None, :, None]
    y = y.reshape(B, S, h * Pd)
    if not heads:                 # whole heads: this rank's d_inner block
        y = _mine(y, inner, ctx)
    y = _gated_norm(y, _mine(z, inner, ctx), p["norm"], ctx, inner)
    return ctx.scatter_seq(dense(y, p["out_proj"]), inner), new_state

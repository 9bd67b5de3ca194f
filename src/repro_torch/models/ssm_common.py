"""Chunked linear attention with per-channel decay: the shared SSM engine
(the port of ``repro.models.ssm_common``).

Both recurrent families reduce to the same state-space recurrence

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t          S in R^{Dk x Dv}
    o_t = q_t . S_{t-1} + bonus                    (RWKV6: strict + u-bonus)
    o_t = q_t . S_t                                (Mamba2: inclusive,
                                                   w scalar)

A sequence is processed in chunks of ``c``: within a chunk the pairwise
decay ratios become a (c, c) masked matmul, and only one (Dk, Dv) state
hand-off per chunk is sequential (a Python loop over the chunks, in f32).
Decay products are evaluated as ``exp(L_t - L_i)`` around a mid-chunk
normalizer; with ``log w`` clamped to [-4, 0] and c = 16 every factor
stays finite (|exponent| <= 32 per factor, products of valid pairs <= 1).

``chunked_la`` (prefill) and ``la_step`` (single-token decode) are the two
entry points.  Both are differentiable (no in-place writes).  The
reference's ``jax.checkpoint`` around the chunk step only trades memory;
the port rematerializes whole layers (``StackedLM.remat``) instead.
"""
from __future__ import annotations

import torch

F32 = torch.float32

LOG_W_MIN = -4.0    # decay clamp; see module docstring for the numerics


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over axis -2, added left to right as XLA's
    ``cumsum`` does (``torch.cumsum`` adds in another order; at |L| near
    64 one f32 ulp of L is 7.6e-6 of every decay factor).  No in-place
    writes, so autograd keeps one small node an add."""
    cols = [x[..., 0, :]]
    for t in range(1, x.shape[-2]):
        cols.append(cols[-1] + x[..., t, :])
    return torch.stack(cols, dim=-2)


def chunked_la(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_w: torch.Tensor, *, u: torch.Tensor | None = None,
               inclusive: bool = False, chunk: int = 16,
               initial_state: torch.Tensor | None = None,
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k, log_w (B, S, H, Dk); v (B, S, H, Dv); u (H, Dk) or None.

    Returns (o (B, S, H, Dv) in q's dtype, final state (B, H, Dk, Dv) f32).
    A length off the chunk grid is zero-padded at the tail: k = v = 0 adds
    nothing to the state and log w = 0 (w = 1) leaves it untouched; the
    padded rows of o are cut off.
    """
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        pz = lambda a: torch.cat(
            [a, a.new_zeros((B, pad) + a.shape[2:])], dim=1)
        o, s_final = chunked_la(pz(q), pz(k), pz(v), pz(log_w), u=u,
                                inclusive=inclusive, chunk=c,
                                initial_state=initial_state)
        return o[:, :S], s_final
    nc = S // c

    def resh(a):                                        # (nc,B,H,c,D)
        return (a.reshape(B, nc, c, H, a.shape[-1])
                 .permute(1, 0, 3, 2, 4).to(F32))

    qc, kc, vc, lw = resh(q), resh(k), resh(v), resh(log_w)
    lw = torch.clamp(lw, LOG_W_MIN, 0.0)
    l_inc = _cumsum(lw)                                 # (nc,B,H,c,Dk)
    l_exc = l_inc - lw
    l_last = l_inc[..., -1:, :]                         # (nc,B,H,1,Dk)
    l_q = l_inc if inclusive else l_exc
    mid = l_inc[..., c // 2, :][..., None, :]           # normalizer

    q_state = qc * torch.exp(l_q)                       # vs incoming state
    q_n = qc * torch.exp(l_q - mid)
    k_n = kc * torch.exp(mid - l_inc)
    k_state = kc * torch.exp(l_last - l_inc)            # into outgoing state

    att = torch.einsum("nbhtd,nbhsd->nbhts", q_n, k_n)  # (nc,B,H,c,c)
    idx = torch.arange(c, device=q.device)
    mask = (idx[:, None] >= idx[None, :]) if inclusive else \
        (idx[:, None] > idx[None, :])
    att = torch.where(mask, att, 0.0)
    o = torch.einsum("nbhts,nbhsv->nbhtv", att, vc)

    if u is not None:
        diag = torch.einsum("nbhtd,nbhtd->nbht",
                            qc * u.to(F32)[None, None, :, None, :], kc)
        o = o + diag[..., None] * vc

    s = (torch.zeros((B, H, Dk, Dv), dtype=F32, device=q.device)
         if initial_state is None else initial_state.to(F32))
    decay = torch.exp(l_last[..., 0, :])[..., None]     # (nc,B,H,Dk,1)
    o_inter = []
    for n in range(nc):
        o_inter.append(torch.einsum("bhtd,bhdv->bhtv", q_state[n], s))
        s = s * decay[n] + torch.einsum("bhtd,bhtv->bhdv", k_state[n],
                                        vc[n])
    o = o + torch.stack(o_inter)                        # (nc,B,H,c,Dv)
    o = o.permute(1, 0, 3, 2, 4).reshape(B, S, H, Dv)
    return o.to(q.dtype), s


def la_step(state: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, log_w: torch.Tensor, *,
            u: torch.Tensor | None = None, inclusive: bool = False,
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence.  state (B, H, Dk, Dv); q, k, log_w (B, H,
    Dk); v (B, H, Dv).  Returns (o (B, H, Dv) in q's dtype, new state f32).
    Strict (RWKV6): the output reads ``s + u·kv`` first, then the state is
    updated; inclusive (Mamba2): the state first, then the output."""
    s = state.to(F32)
    qf, kf, vf = (a.to(F32) for a in (q, k, v))
    w = torch.exp(torch.clamp(log_w.to(F32), LOG_W_MIN, 0.0))
    kv = kf[..., :, None] * vf[..., None, :]            # (B,H,Dk,Dv)
    if inclusive:
        s_new = s * w[..., None] + kv
        o = torch.einsum("bhd,bhdv->bhv", qf, s_new)
    else:
        bonus = kv * u.to(F32)[None, :, :, None]
        o = torch.einsum("bhd,bhdv->bhv", qf, s + bonus)
        s_new = s * w[..., None] + kv
    return o.to(q.dtype), s_new

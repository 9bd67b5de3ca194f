"""Zamba2 hybrid: a Mamba2 backbone and ONE shared full-attention block
(the port of ``repro.models.zamba2`` as an ``nn.Module``: ``hidden`` /
``forward`` / ``loss`` differentiable, ``prefill`` / ``decode_step``
under ``no_grad``).

Per arXiv:2411.15242 the attention block's weights are shared across all
of its invocations (after every ``hybrid_attn_every`` mamba layers); its
input is the concat of the current hidden state and the original
embeddings (2d wide), projected back to d by the output projection.  As in
the reference, the per-invocation LoRA deltas are omitted, and decode
keeps a ring-buffer KV cache of ``min(ATTN_WINDOW, max_len)`` positions
per invocation: slot ``pos % W``, valid entries the last ``min(len, W)``
positions.

The cache: {"mamba": {"conv": (L, B, W-1, C), "s": (L, B, H, N, P) f32},
"attn": {"k", "v": (G, B, W, H, hd) bf16, "pos": (G, B, W), "len": (G,
B)}, "x0": (B, d)} for L mamba layers and G invocations.  ``decode_step``
writes into the cache it is given (the reference returns a new one).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .attention import _bf16_f32, _write_slot, chunked_attention
from .base import (NULL_CTX, P, ShardCtx, StackedLM, dense, dense_out,
                   next_token_loss, rms_norm)
from .ffn import decls_mlp, mlp_forward
from .mamba2 import decls_mamba, init_mamba_state, mamba_forward
from .rope import apply_rope, rope_angles
from .transformer import _stack

BF16, F32 = torch.bfloat16, torch.float32
ATTN_WINDOW = 8192     # decode ring-buffer length per shared-block invocation
EMPTY_POS = -10 ** 9   # position of a ring slot that holds nothing yet


class Zamba2LM(StackedLM):
    """Zamba2 of one config on one device (``StackedLM``)."""

    def __init__(self, cfg, ctx: ShardCtx = NULL_CTX, *,
                 device: str | torch.device | None = None):
        if cfg.ssm is None or cfg.hybrid_attn_every <= 0:
            raise ValueError(f"{cfg.name} is not a hybrid config")
        self.d_concat = 2 * cfg.d_model
        self.attn_head_dim = self.d_concat // cfg.n_heads
        self.n_invocations = cfg.n_layers // cfg.hybrid_attn_every
        super().__init__(cfg, ctx, device=device)

    # -- declarations ---------------------------------------------------------
    def _shared_decls(self) -> dict:
        cfg = self.cfg
        dc, hq, hd = self.d_concat, cfg.n_heads, self.attn_head_dim
        return {
            "ln_in": P((dc,), (None,), init="zeros"),
            "wq": P((dc, hq, hd), ("embed", "heads", None)),
            "wk": P((dc, hq, hd), ("embed", "heads", None)),
            "wv": P((dc, hq, hd), ("embed", "heads", None)),
            "wo": P((hq, hd, cfg.d_model), ("heads", None, "embed")),
            "ln_mlp": P((cfg.d_model,), (None,), init="zeros"),
            "mlp": decls_mlp(cfg.d_model, cfg.d_ff),
        }

    def decls(self) -> dict:
        cfg = self.cfg
        return {
            "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       scale=1.0),
            "final_norm": P((cfg.d_model,), (None,), init="zeros"),
            "lm_head": P((cfg.d_model, cfg.vocab), ("embed", "vocab")),
            "shared_attn": self._shared_decls(),
            "layers": _stack({"ln": P((cfg.d_model,), (None,),
                                      init="zeros"),
                              "mamba": decls_mamba(cfg)}, cfg.n_layers),
        }

    def groups(self) -> list[tuple[range, int | None]]:
        """(mamba layers, shared-block invocation after them or None): the
        full groups of ``hybrid_attn_every`` layers, then the tail."""
        every, L = self.cfg.hybrid_attn_every, self.cfg.n_layers
        out = [(range(g * every, (g + 1) * every), g)
               for g in range(self.n_invocations)]
        if L > self.n_invocations * every:
            out.append((range(self.n_invocations * every, L), None))
        return out

    # -- blocks ---------------------------------------------------------------
    def _mamba(self, i: int, h: torch.Tensor, state: dict | None = None):
        p = self.params["layers"][i]
        out, st = mamba_forward(p["mamba"], rms_norm(h, p["ln"]), self.cfg,
                                state=state)
        return h + out, st

    def _shared_attn(self, x: torch.Tensor, x0: torch.Tensor,
                     positions: torch.Tensor, cache: dict | None = None,
                     fill_window: int | None = None):
        """The shared block on concat(x, x0) -> (x, ring cache or None).

        ``cache`` set (decode, S = 1): the token's k / v are written at
        slot ``len % W`` of that invocation's ring in place, its
        ``pos`` / ``len`` updated, and the token attends to the valid
        slots.  ``fill_window`` set (prefill): a new ring of that length
        holding the last min(W, S) positions at their ``pos % W`` slots."""
        cfg, p = self.cfg, self.params["shared_attn"]
        hd = self.attn_head_dim
        scale = 1.0 / math.sqrt(hd)
        xc = rms_norm(torch.cat([x, x0], dim=-1), p["ln_in"])
        q, k, v = dense(xc, p["wq"]), dense(xc, p["wk"]), dense(xc, p["wv"])
        ang = rope_angles(positions, hd, cfg.rope_theta)
        q, k = apply_rope(q, ang), apply_rope(k, ang)

        new_cache = None
        if cache is None:
            B, S = x.shape[:2]
            o = chunked_attention(q, k, v, scale=scale,
                                  q_chunk=min(cfg.attn_chunk_q, S),
                                  k_chunk=min(cfg.attn_chunk_k, S))
            if fill_window is not None:
                W = fill_window
                n_keep = min(W, S)
                keep_pos = torch.arange(S - n_keep, S, device=x.device)
                slots = keep_pos % W
                mk = k.new_zeros((B, W) + k.shape[2:], dtype=BF16)
                mv = v.new_zeros((B, W) + v.shape[2:], dtype=BF16)
                mk[:, slots] = k[:, -n_keep:].to(BF16)
                mv[:, slots] = v[:, -n_keep:].to(BF16)
                pos = torch.full((B, W), EMPTY_POS, dtype=torch.int32,
                                 device=x.device)
                pos[:, slots] = keep_pos.to(torch.int32)
                new_cache = dict(k=mk, v=mv, pos=pos,
                                 len=torch.full((B,), S, dtype=torch.int32,
                                                device=x.device))
        else:
            W = cache["k"].shape[1]
            n = cache["len"].clone()                    # (B,) tokens so far
            slot = n % W
            _write_slot(cache["k"], k, slot)
            _write_slot(cache["v"], v, slot)
            rows = torch.arange(n.shape[0], device=x.device)
            cache["pos"][rows, slot.long()] = n
            cache["len"].copy_(n + 1)
            valid = (cache["pos"] <= n[:, None]) & (
                cache["pos"] > n[:, None] - W)
            logits = torch.einsum("bhd,bkhd->bhk", _bf16_f32(q[:, 0]),
                                  _bf16_f32(cache["k"])) * scale
            logits = torch.where(valid[:, None, :], logits,
                                 torch.tensor(-math.inf, dtype=F32,
                                              device=x.device))
            pr = torch.softmax(logits, dim=-1)
            o = torch.einsum("bhk,bkhd->bhd", _bf16_f32(pr),
                             _bf16_f32(cache["v"]))[:, None].to(x.dtype)
            new_cache = cache

        x = x + dense_out(o, p["wo"])
        x = x + mlp_forward(p["mlp"], rms_norm(x, p["ln_mlp"]), cfg.act)
        return x, new_cache

    # -- LM interface ---------------------------------------------------------
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens.long(), self.params["embed"]).to(
            self.compute_dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final RMS norm and head -> f32 logits."""
        x = rms_norm(x, self.params["final_norm"])
        return (x @ self.params["lm_head"].to(x.dtype)).to(F32)

    @staticmethod
    def _positions(tokens: torch.Tensor, positions):
        if positions is None:
            return torch.arange(tokens.shape[1], device=tokens.device)[None]
        return positions

    def hidden(self, tokens: torch.Tensor, positions=None,
               extra_embeds=None) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (final hidden states (B, S, d) before the final norm, a zero
        aux loss).  Each mamba layer runs under ``remat`` when the config
        sets it; the shared block does not, as in the reference."""
        positions = self._positions(tokens, positions)
        x0 = self.embed(tokens)
        x = x0
        for layers, g in self.groups():
            for i in layers:
                x, _ = self.remat(self._mamba, i, x)
            if g is not None:
                x, _ = self._shared_attn(x, x0, positions)
        return x, torch.zeros((), dtype=F32, device=x.device)

    def forward(self, tokens: torch.Tensor, positions=None,
                extra_embeds=None) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (logits, aux_loss)."""
        x, aux = self.hidden(tokens, positions)
        return self.logits(x), aux

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Next-token CE + z-loss (``tokens`` only, as the
        reference's)."""
        logits, aux = self.forward(batch["tokens"])
        ce, zl = next_token_loss(logits, batch["tokens"])
        return ce + zl, {"ce": ce, "aux": aux, "zloss": zl}

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = BF16) -> dict:
        cfg = self.cfg
        W = min(ATTN_WINDOW, max_len)
        G, hq, hd = self.n_invocations, cfg.n_heads, self.attn_head_dim
        dev = self.device
        one = init_mamba_state(cfg, batch, dtype, dev)
        return {
            "mamba": {k: torch.stack([v] * cfg.n_layers)
                      for k, v in one.items()},
            "attn": dict(
                k=torch.zeros((G, batch, W, hq, hd), dtype=dtype,
                              device=dev),
                v=torch.zeros((G, batch, W, hq, hd), dtype=dtype,
                              device=dev),
                pos=torch.full((G, batch, W), EMPTY_POS,
                               dtype=torch.int32, device=dev),
                len=torch.zeros((G, batch), dtype=torch.int32, device=dev)),
            "x0": torch.zeros((batch, cfg.d_model), dtype=dtype, device=dev),
        }

    def cache_axes(self) -> dict:
        return {
            "mamba": dict(conv=("layers", "batch", None, "mlp"),
                          s=("layers", "batch", "heads", None, None)),
            "attn": dict(k=(None, "batch", None, "heads", "head_dim"),
                         v=(None, "batch", None, "heads", "head_dim"),
                         pos=(None, "batch", None),
                         len=(None, "batch")),
            "x0": ("batch", None),
        }

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, positions: torch.Tensor,
                max_len: int, extra_embeds=None):
        """Full-prompt pass -> (last-position logits, {mamba states, ring
        caches of min(ATTN_WINDOW, max_len) slots, x0 of the last
        position})."""
        positions = self._positions(tokens, positions)
        W = min(ATTN_WINDOW, max_len)
        x0 = self.embed(tokens)
        x = x0
        states, rings = [], []
        for layers, g in self.groups():
            for i in layers:
                x, st = self._mamba(i, x)
                states.append(st)
            if g is not None:
                x, c = self._shared_attn(x, x0, positions, fill_window=W)
                rings.append(c)
        cache = {
            "mamba": {k: torch.stack([st[k] for st in states])
                      for k in ("conv", "s")},
            "attn": {k: torch.stack([c[k] for c in rings])
                     for k in ("k", "v", "pos", "len")},
            "x0": x0[:, -1].clone(),
        }
        return self.logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """One token: tokens (B, 1) -> (logits (B, 1, V), cache).  The
        cache is updated in place and returned."""
        x0 = self.embed(tokens)
        x = x0
        mamba, attn = cache["mamba"], cache["attn"]
        for layers, g in self.groups():
            for i in layers:
                x, st = self._mamba(i, x, {k: v[i] for k, v in mamba.items()})
                for k, v in st.items():
                    mamba[k][i] = v
            if g is not None:
                x, _ = self._shared_attn(x, x0, positions,
                                         cache={k: v[g]
                                                for k, v in attn.items()})
        cache["x0"].copy_(x0[:, 0])
        return self.logits(x), cache

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

Built with a ``ShardCtx`` on a mesh it is tensor parallel (``StackedLM``;
the reference's constraint points ``zamba2.py:98,99,157,172,203``): the
residual stream and ``x0`` hold this rank's rows and, where the sequence
divides the model axis, its positions.  The mamba layers take
``mamba_forward(ctx=)``.  The shared block takes ``concat(x, x0)`` and
``ln_in`` on this rank's positions and all-gathers the sequence; its
``wq`` / ``wk`` / ``wv`` are this rank's heads and ``wo`` is row
parallel, and its MLP is ``mlp_forward(ctx=)``.  Heads that do not
divide the model axis are whole: the prefill then runs context parallel
(``chunked_attention``), the ring cache holds this rank's head_dim slice
(``cache_axes``) and a decode step takes ``decode_attention``'s head_dim
leg with the ring's mask.  The embedding is a vocab-parallel lookup and
the logits stay vocab-sharded; the cache is this rank's blocks under
``cache_axes``.
"""
from __future__ import annotations

import math

import torch

from .attention import (_cache_block, _write_slot, chunked_attention,
                        decode_attention)
from .base import (NULL_CTX, P, ShardCtx, StackedLM, dense, dense_out,
                   model_split, rms_norm)
from .ffn import decls_mlp, mlp_forward
from .mamba2 import decls_mamba, mamba_dims, mamba_forward
from .rope import apply_rope, rope_angles
from .transformer import _stack

BF16, F32 = torch.bfloat16, torch.float32
ATTN_WINDOW = 8192     # decode ring-buffer length per shared-block invocation
EMPTY_POS = -10 ** 9   # position of a ring slot that holds nothing yet


class Zamba2LM(StackedLM):
    """Zamba2 of one config on one device, or tensor parallel on a mesh
    (``StackedLM``)."""

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
    def _mamba(self, i: int, h: torch.Tensor, S: int,
               state: dict | None = None):
        """Mamba layer ``i`` on ``h`` (the layer boundary's layout of a
        sequence of ``S``)."""
        p = self.params["layers"][i]
        out, st = mamba_forward(
            p["mamba"], self.ctx.gather_seq(rms_norm(h, p["ln"]), S),
            self.cfg, ctx=self.ctx, state=state)
        return h + out, st

    def _shared_attn(self, x: torch.Tensor, x0: torch.Tensor,
                     positions: torch.Tensor, cache: dict | None = None,
                     fill_window: int | None = None):
        """The shared block on concat(x, x0) -> (x, ring cache or None).

        ``cache`` set (decode, S = 1): the token's k / v are written at
        slot ``len % W`` of that invocation's ring in place, its
        ``pos`` / ``len`` updated, and the token attends to the valid
        slots.  ``fill_window`` set (prefill): a new ring of that length
        holding the last min(W, S) positions at their ``pos % W`` slots.
        On a mesh ``x`` / ``x0`` are at the layer boundary's layout and
        the ring is this rank's block under ``cache_axes``."""
        cfg, ctx, p = self.cfg, self.ctx, self.params["shared_attn"]
        hd = self.attn_head_dim
        scale = 1.0 / math.sqrt(hd)
        S = positions.shape[-1]
        heads = model_split(p, "wq", 1)
        xc = ctx.gather_seq(rms_norm(torch.cat([x, x0], dim=-1),
                                     p["ln_in"]), S)
        q, k, v = dense(xc, p["wq"]), dense(xc, p["wk"]), dense(xc, p["wv"])
        ang = rope_angles(positions, hd, cfg.rope_theta)
        q, k = apply_rope(q, ang), apply_rope(k, ang)
        leg = NULL_CTX if heads else ctx    # whole heads: the mesh's legs

        new_cache = None
        if cache is None:
            B = x.shape[0]
            o = chunked_attention(q, k, v, scale=scale,
                                  q_chunk=min(cfg.attn_chunk_q, S),
                                  k_chunk=min(cfg.attn_chunk_k, S), ctx=leg)
            if fill_window is not None:
                W = fill_window
                n_keep = min(W, S)
                keep_pos = torch.arange(S - n_keep, S, device=x.device)
                slots = keep_pos % W
                kb, vb = _cache_block(k, ctx, heads), _cache_block(v, ctx,
                                                                   heads)
                mk = kb.new_zeros((B, W) + kb.shape[2:], dtype=BF16)
                mv = vb.new_zeros((B, W) + vb.shape[2:], dtype=BF16)
                mk[:, slots] = kb[:, -n_keep:].to(BF16)
                mv[:, slots] = vb[:, -n_keep:].to(BF16)
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
            _write_slot(cache["k"], _cache_block(k, ctx, heads), slot)
            _write_slot(cache["v"], _cache_block(v, ctx, heads), slot)
            rows = torch.arange(n.shape[0], device=x.device)
            cache["pos"][rows, slot.long()] = n
            cache["len"].copy_(n + 1)
            valid = (cache["pos"] <= n[:, None]) & (
                cache["pos"] > n[:, None] - W)
            o = decode_attention(q, cache["k"], cache["v"], None,
                                 scale=scale, ctx=leg, valid=valid)
            new_cache = cache

        x = x + ctx.scatter_seq(dense_out(o, p["wo"]), heads)
        x = x + mlp_forward(p["mlp"], ctx.gather_seq(
            rms_norm(x, p["ln_mlp"]), S), cfg.act, ctx=ctx)
        return x, new_cache

    # -- LM interface ---------------------------------------------------------
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings in the compute dtype (``x0``); on a mesh a
        vocab-parallel lookup (``StackedLM.lookup``) reduce-scattered to
        the layer boundary's layout."""
        x = self.lookup(tokens.long(), self.params["embed"]).to(
            self.compute_dtype)
        return self.ctx.scatter_seq(x, self._vocab() is not None)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final RMS norm and head -> f32 logits; on a mesh ``x`` is whole
        over the sequence and the logits are this rank's vocab block
        (``gather_vocab`` assembles them)."""
        x = rms_norm(x, self.params["final_norm"])
        return (x @ self.params["lm_head"].to(x.dtype)).to(F32)

    @staticmethod
    def _positions(tokens: torch.Tensor, positions):
        if positions is None:
            return torch.arange(tokens.shape[1], device=tokens.device)[None]
        return positions

    def hidden(self, tokens: torch.Tensor, positions=None,
               extra_embeds=None, *, batch: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (final hidden states (B, S, d) before the final norm, a zero
        aux loss).  Each mamba layer runs under ``remat`` when the config
        sets it; the shared block does not, as in the reference.  On a
        mesh the states are gathered whole over the sequence, and with
        ``batch`` (the global batch of which ``tokens`` are this rank's
        rows) over the rows too."""
        positions = self._positions(tokens, positions)
        S = positions.shape[-1]
        x0 = self.embed(tokens)
        x = x0
        for layers, g in self.groups():
            for i in layers:
                x, _ = self.remat(self._mamba, i, x, S)
            if g is not None:
                x, _ = self._shared_attn(x, x0, positions)
        x = self.ctx.gather_seq(x, S)
        if batch is not None:
            x = self.ctx.gather_rows(x, batch)
        return x, torch.zeros((), dtype=F32, device=x.device)

    def forward(self, tokens: torch.Tensor, positions=None,
                extra_embeds=None) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (logits, aux_loss); on a mesh the logits are this rank's
        vocab block."""
        x, aux = self.hidden(tokens, positions)
        return self.logits(x), aux

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Next-token CE + z-loss (``tokens`` only, as the reference's);
        on a mesh vocab parallel, the same value on every rank of the
        model axis."""
        logits, aux = self.forward(batch["tokens"])
        ce, zl = self.token_loss(logits, batch["tokens"])
        return ce + zl, {"ce": ce, "aux": aux, "zloss": zl}

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = BF16) -> dict:
        """The empty cache of ``batch`` rows; on a mesh this rank's blocks
        under ``cache_axes``."""
        cfg, s = self.cfg, self.cfg.ssm
        W = min(ATTN_WINDOW, max_len)
        G, hq, hd = self.n_invocations, cfg.n_heads, self.attn_head_dim
        L, dims = cfg.n_layers, mamba_dims(cfg)
        axes = self.cache_axes()
        z = lambda part, k, shape, dt, fill=0: torch.full(
            self.ctx.model_block(shape, axes[part][k]), fill, dtype=dt,
            device=self.device)
        return {
            "mamba": dict(
                conv=z("mamba", "conv", (L, batch, s.conv_width - 1,
                                         dims["conv_ch"]), dtype),
                s=z("mamba", "s", (L, batch, dims["n_heads"], s.state_dim,
                                   s.head_dim), F32)),
            "attn": dict(
                k=z("attn", "k", (G, batch, W, hq, hd), dtype),
                v=z("attn", "v", (G, batch, W, hq, hd), dtype),
                pos=z("attn", "pos", (G, batch, W), torch.int32, EMPTY_POS),
                len=z("attn", "len", (G, batch), torch.int32)),
            "x0": torch.zeros((batch, cfg.d_model), dtype=dtype,
                              device=self.device),
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
        position}).  On a mesh the tokens are this rank's rows, the logits
        its vocab block, the cache its blocks under ``cache_axes``, and
        the last position the last rank's."""
        positions = self._positions(tokens, positions)
        S = positions.shape[-1]
        W = min(ATTN_WINDOW, max_len)
        x0 = self.embed(tokens)
        x = x0
        states, rings = [], []
        for layers, g in self.groups():
            for i in layers:
                x, st = self._mamba(i, x, S)
                states.append(st)
            if g is not None:
                x, c = self._shared_attn(x, x0, positions, fill_window=W)
                rings.append(c)
        cache = {
            "mamba": {k: torch.stack([st[k] for st in states])
                      for k in ("conv", "s")},
            "attn": {k: torch.stack([c[k] for c in rings])
                     for k in ("k", "v", "pos", "len")},
            "x0": self.last_position(x0, S)[:, 0].clone(),
        }
        return self.logits(self.last_position(x, S)), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """One token: tokens (B, 1) -> (logits (B, 1, V), cache).  The
        cache is updated in place and returned.  On a mesh as
        ``prefill``."""
        x0 = self.embed(tokens)
        x = x0
        mamba, attn = cache["mamba"], cache["attn"]
        for layers, g in self.groups():
            for i in layers:
                x, st = self._mamba(i, x, 1,
                                    {k: v[i] for k, v in mamba.items()})
                for k, v in st.items():
                    mamba[k][i] = v
            if g is not None:
                x, _ = self._shared_attn(x, x0, positions,
                                         cache={k: v[g]
                                                for k, v in attn.items()})
        cache["x0"].copy_(x0[:, 0])
        return self.logits(x), cache

"""Decoder-only transformer (dense / moe / vlm / audio families): the port
of ``repro.models.transformer`` as an ``nn.Module``.

The parameters live in ``self.params`` as ``base.StackedLM`` lays them
out: the reference's tree with its stacked ``"layers"`` axis unstacked,
every weight in the reference's layout (``wq`` (d, H, hd), ``lm_head``
(d, V)).  Heterogeneous leading layers (DeepSeek's dense first layer) sit in
``params.front``.  ``forward`` runs the front layers, then the stacked
layers, as a Python loop.

Built with a ``ShardCtx`` on a mesh it is tensor parallel
(``StackedLM``): each weight is this rank's block over the model axis,
the residual stream between layers holds this rank's rows and, where the
sequence divides the model axis, its positions (``act_rules``' layout
``("batch", "seq", None)``), each block all-gathers the sequence after
its norms (``_block``), the embedding is a masked lookup in this rank's
vocab rows reduce-scattered to the sequence shard, the logits stay
vocab-sharded and the loss takes a vocab-parallel log-softmax.  Caches
are this rank's blocks under ``cache_axes``.

``hidden`` / ``forward`` / ``loss`` run under autograd when the caller
records it (the train step runs them on a tree it differentiates,
``StackedLM.bound``); with ``cfg.remat`` each layer, front layers too,
is then recomputed in the backward (``StackedLM.remat``), as the
reference's ``jax.checkpoint``.  ``prefill`` / ``decode_step`` run under
``no_grad``.  The reference's ``scan_layers`` is a compilation knob the
port does not read: it has no scan to trace.

The modality frontends for the [vlm]/[audio] architectures are stubs, as
in the reference: ``qwen2-vl`` consumes precomputed patch embeddings
(prepended to the text tokens, M-RoPE positions supplied by the caller)
and ``musicgen`` consumes EnCodec token streams (``n_codebooks`` parallel
vocabularies, embedded and summed, one output head per codebook).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from .. import tracing
from .attention import attn_decls, attn_forward, init_attn_cache
from .base import P, StackedLM, layer_norm, rms_norm, tree_map
from .config import ModelConfig
from .ffn import decls_mlp, decls_moe, mlp_forward, moe_forward


def _stack(decls: Any, n: int) -> Any:
    """Add a leading stacked-layer axis to every declaration in the tree."""
    return tree_map(lambda p: P((n,) + p.shape, ("layers",) + p.axes,
                                p.dtype, p.init, p.scale), decls)


def _norm_decl(cfg: ModelConfig) -> dict:
    if cfg.norm == "layer":
        return {"gamma": P((cfg.d_model,), (None,), init="ones"),
                "beta": P((cfg.d_model,), (None,), init="zeros")}
    return {"gamma": P((cfg.d_model,), (None,), init="zeros")}


def _norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "layer":
        return layer_norm(x, p["gamma"], p["beta"])
    return rms_norm(x, p["gamma"])


class TransformerLM(StackedLM):
    """The transformer LM of one config on one device, or tensor parallel
    on a mesh (``StackedLM``: built with ``device=None`` it lives on
    ``cuda``; ``"meta"`` allocates nothing)."""

    @property
    def n_front(self) -> int:
        return self.cfg.moe.first_dense_layers if self.cfg.moe else 0

    @property
    def n_stacked(self) -> int:
        return self.cfg.n_layers - self.n_front

    # -- declarations -------------------------------------------------------
    def _block_decls(self, moe_layer: bool) -> dict:
        cfg = self.cfg
        d = {
            "ln1": _norm_decl(cfg),
            "ln2": _norm_decl(cfg),
            "attn": attn_decls(cfg),
        }
        if moe_layer:
            d["moe"] = decls_moe(cfg)
        else:
            ff = cfg.d_ff
            if cfg.moe is not None and cfg.moe.d_ff_dense:
                ff = cfg.moe.d_ff_dense
            d["mlp"] = decls_mlp(cfg.d_model, ff, cfg.mlp_gated)
        return d

    def decls(self) -> dict:
        """The reference's declaration tree (stacked ``"layers"`` axis)."""
        cfg = self.cfg
        audio = cfg.modality == "audio" and cfg.n_codebooks > 1
        decls: dict[str, Any] = {
            "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       scale=1.0),
            "final_norm": _norm_decl(cfg),
            "layers": _stack(self._block_decls(cfg.moe is not None),
                             self.n_stacked),
        }
        if audio:
            decls["embed"] = P((cfg.n_codebooks, cfg.vocab, cfg.d_model),
                               (None, "vocab", "embed"), scale=1.0)
        if self.n_front:
            decls["front"] = [self._block_decls(False)
                              for _ in range(self.n_front)]
        if not cfg.tie_embeddings:
            shape = (cfg.d_model, cfg.vocab)
            if audio:
                decls["lm_head"] = P((cfg.n_codebooks,) + shape,
                                     (None, "embed", "vocab"))
            else:
                decls["lm_head"] = P(shape, ("embed", "vocab"))
        return decls

    # -- blocks --------------------------------------------------------------
    def _block(self, p, x: torch.Tensor, positions: torch.Tensor, *,
               moe_layer: bool, cache: dict | None = None,
               fill_len: int | None = None):
        """One layer; on a mesh ``x`` is at the layer boundary's layout
        and each norm's output is all-gathered over the sequence before
        the attention / FFN (the reference's ``transformer.py:116``)."""
        cfg, ctx = self.cfg, self.ctx
        S = positions.shape[-1]
        h, new_cache = attn_forward(
            p["attn"], ctx.gather_seq(_norm(p["ln1"], x, cfg), S),
            positions, cfg, ctx=ctx, cache=cache, fill_len=fill_len)
        x = x + h
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = ctx.gather_seq(_norm(p["ln2"], x, cfg), S)
        if moe_layer:
            h, aux = moe_forward(p["moe"], h, cfg, ctx=ctx)
        else:
            h = mlp_forward(p["mlp"], h, cfg.act, ctx=ctx)
        return x + h, aux, new_cache

    # -- embedding / head ----------------------------------------------------
    def embed(self, tokens: torch.Tensor,
              extra_embeds: torch.Tensor | None = None) -> torch.Tensor:
        """Token embeddings in the compute dtype: audio codebooks summed,
        tied embeddings scaled by sqrt(d), vlm patch embeddings
        (``extra_embeds`` (B, S_img, d)) prepended to the text.  On a mesh
        (the reference's ``transformer.py:132``) a vocab-sharded table is
        looked up where the token is this rank's (``StackedLM.lookup``)
        and the partial sums reduce-scattered to ``("batch", "seq",
        None)``."""
        cfg, ctx = self.cfg, self.ctx
        emb = self.params["embed"]
        tokens = tokens.long()
        vocab = self._vocab()
        if cfg.modality == "audio" and cfg.n_codebooks > 1:
            x = sum(self.lookup(tokens[..., c], emb[c])
                    for c in range(cfg.n_codebooks))
        else:
            x = self.lookup(tokens, emb)
        x = x.to(self.compute_dtype)
        if cfg.tie_embeddings:
            x = x * math.sqrt(cfg.d_model)
        if extra_embeds is not None:
            extra = extra_embeds.to(x.dtype)
            if vocab is not None:
                extra = ctx.as_partial(extra)
            x = torch.cat([extra, x], dim=1)
        return ctx.scatter_seq(x, vocab is not None)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and head -> f32 logits (B, S, V), or (B, S, C, V)
        for the audio codebooks.  On a mesh ``x`` is whole over the
        sequence and the logits are this rank's vocab block (the
        reference's ``transformer.py:152``); ``gather_vocab`` assembles
        them."""
        cfg = self.cfg
        x = self.normed(x)
        if cfg.tie_embeddings:
            out = x @ self.params["embed"].to(x.dtype).T
        elif cfg.modality == "audio" and cfg.n_codebooks > 1:
            out = torch.einsum("bsd,cdv->bscv", x,
                               self.params["lm_head"].to(x.dtype))
        else:
            out = x @ self.params["lm_head"].to(x.dtype)
        return out.to(torch.float32)

    def normed(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm of ``hidden``'s states (what ``logits``
        projects, and a classifier pools)."""
        return _norm(self.params["final_norm"], x, self.cfg)

    # -- full forward ---------------------------------------------------------
    def _stack(self, tokens: torch.Tensor, positions: torch.Tensor,
               extra_embeds: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (final hidden states before the final norm at the layer
        boundary's layout, aux loss)."""
        x = self.embed(tokens, extra_embeds)
        for p in self.params["front"] if "front" in self.params else ():
            x, _, _ = self.remat(self._block, p, x, positions,
                                 moe_layer=False)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        moe_layer = self.cfg.moe is not None
        for p in self.params["layers"]:
            x, a, _ = self.remat(self._block, p, x, positions,
                                 moe_layer=moe_layer)
            aux = aux + a
        return x, aux

    def hidden(self, tokens: torch.Tensor, positions: torch.Tensor,
               extra_embeds: torch.Tensor | None = None, *,
               batch: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (final hidden states (B, S, d) before the final norm, aux
        loss): the stack ``forward`` and ``prefill`` run.  On a mesh the
        states are gathered whole over the sequence, and with ``batch``
        (the global batch of which ``tokens`` are this rank's rows) over
        the rows too: what ``pool_features`` and the CoTM head read.
        Span ``lm.hidden``, counter ``lm.tokens`` (``tracing``)."""
        with tracing.span("lm.hidden"):
            tracing.add("lm.tokens", tokens.shape[0] * tokens.shape[1])
            x, aux = self._stack(tokens, positions, extra_embeds)
            x = self.ctx.gather_seq(x, positions.shape[-1])
            if batch is not None:
                x = self.ctx.gather_rows(x, batch)
        return x, aux

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                extra_embeds: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (logits, aux_loss); on a mesh the logits are this rank's
        vocab block."""
        x, aux = self.hidden(tokens, positions, extra_embeds)
        return self.logits(x), aux

    # -- loss ----------------------------------------------------------------
    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Next-token CE + z-loss + MoE aux.  batch: tokens
        (B, S[, C]), optional loss_mask, positions, extra_embeds.  On a
        mesh the same value on every rank of the model axis; a
        vocab-sharded head takes the vocab-parallel loss
        (``StackedLM.token_loss``)."""
        tokens = batch["tokens"]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]
        logits, aux = self.forward(tokens, positions,
                                   batch.get("extra_embeds"))
        if batch.get("extra_embeds") is not None:
            logits = logits[:, -tokens.shape[1]:]    # text positions only
        ce, zl = self.token_loss(logits, tokens, batch.get("loss_mask"))
        return ce + zl + aux, {"ce": ce, "aux": aux, "zloss": zl}

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        """{"layers": {name: (L, ...)}, "front": [one layer's, ...]}, the
        reference's layout: each stacked leaf has a leading layer axis.
        On a mesh ``batch`` rows of this rank's blocks under
        ``cache_axes``."""
        axes = self.cache_axes()["layers"]
        axes = {k: v[1:] for k, v in axes.items()}
        one = lambda: init_attn_cache(self.cfg, batch, max_len, dtype,
                                      self.device, self.ctx, axes)
        cache = {"layers": {k: torch.stack([v] * self.n_stacked)
                            for k, v in one().items()}}
        if self.n_front:
            cache["front"] = [one() for _ in range(self.n_front)]
        return cache

    def cache_axes(self) -> dict:
        """Logical axes of the cache tree, leaf for leaf (the serving
        engine finds each leaf's batch axis here)."""
        if self.cfg.mla is not None:
            one = {"ckv": ("batch", None, "head_dim"),
                   "kr": ("batch", None, "head_dim"), "len": ("batch",)}
        else:
            one = {"k": ("batch", None, "kv", "head_dim"),
                   "v": ("batch", None, "kv", "head_dim"),
                   "len": ("batch",)}
        axes = {"layers": {k: ("layers",) + v for k, v in one.items()}}
        if self.n_front:
            axes["front"] = [dict(one) for _ in range(self.n_front)]
        return axes

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, positions: torch.Tensor,
                max_len: int, extra_embeds: torch.Tensor | None = None):
        """Process a full prompt -> (last-position logits, cache padded to
        max_len).  On a mesh the reference's ``transformer.py:208-276``:
        the tokens are this rank's rows (``launch.specs.prefill_axes``),
        the logits its vocab block and the cache its blocks under
        ``cache_axes``."""
        x = self.embed(tokens, extra_embeds)
        new_front = []
        for p in self.params["front"] if "front" in self.params else ():
            x, _, c = self._block(p, x, positions, moe_layer=False,
                                  fill_len=max_len)
            new_front.append(c)
        moe_layer = self.cfg.moe is not None
        layer_caches = []
        for p in self.params["layers"]:
            x, _, c = self._block(p, x, positions, moe_layer=moe_layer,
                                  fill_len=max_len)
            layer_caches.append(c)
        cache = {"layers": {k: torch.stack([c[k] for c in layer_caches])
                            for k in layer_caches[0]}}
        if new_front:
            cache["front"] = new_front
        return self.logits(self.last_position(x, positions.shape[-1])), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """One decode step: tokens (B, 1[, C]) -> (logits (B, 1, V[, C]),
        cache).  The cache is updated in place and returned.  On a mesh as
        ``prefill`` (``launch.specs.decode_axes``)."""
        x = self.embed(tokens)
        for p, c in zip(self.params["front"] if "front" in self.params
                        else (), cache.get("front", [])):
            x, _, new = self._block(p, x, positions, moe_layer=False,
                                    cache=c)
            c["len"] = new["len"]
        moe_layer = self.cfg.moe is not None
        stacked = cache["layers"]
        for i, p in enumerate(self.params["layers"]):
            c = {k: v[i] for k, v in stacked.items()}
            x, _, new = self._block(p, x, positions, moe_layer=moe_layer,
                                    cache=c)
            stacked["len"][i] = new["len"]
        return self.logits(x), cache

"""Decoder-only transformer (dense / moe / vlm / audio families): the port
of ``repro.models.transformer`` as an inference ``nn.Module``.

The parameters live in ``self.params``, a ``ParamTree`` whose keys are the
reference's parameter tree with its stacked ``"layers"`` axis unstacked
into an ``nn.ModuleList`` (``params.layers.3.attn.wq`` is the reference's
``params["layers"]["attn"]["wq"][3]``); every weight keeps the reference's
layout (``wq`` (d, H, hd), ``lm_head`` (d, V)), so converting a parameter
tree is a copy (``repro_torch.convert.lm_params_from_arrays``).
Heterogeneous leading layers (DeepSeek's dense first layer) sit in
``params.front``.  ``forward`` runs the front layers, then the stacked
layers, as a Python loop.

The reference's ``remat`` and ``scan_layers`` (rematerialization and
``lax.scan`` over the stacked layers) are compilation and training knobs:
an inference module has no backward to rematerialize for and no scan to
trace, so the port reads neither.  ``loss`` is a value; its gradient is
not ported yet.

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
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .attention import attn_decls, attn_forward, init_attn_cache
from .base import (P, ParamTree, abstract, count_params, init_leaf,
                   layer_norm, leaves, rms_norm, tree_map)
from .config import ModelConfig, torch_dtype
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


class TransformerLM(nn.Module):
    """The LM of one config on one device.  Built with ``device=None`` it
    lives on ``cuda`` (raising without a card); ``"meta"`` allocates
    nothing.  Parameters start uninitialized: fill them with ``init`` or
    copy them in (``convert.lm_params_from_arrays``)."""

    def __init__(self, cfg: ModelConfig, *,
                 device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        decls = self.decls()
        tree = {k: v for k, v in decls.items() if k != "layers"}
        tree["layers"] = [self._block_decls(cfg.moe is not None)
                          for _ in range(self.n_stacked)]
        self.params = ParamTree(tree, dev, torch_dtype(cfg.param_dtype))

    @property
    def n_front(self) -> int:
        return self.cfg.moe.first_dense_layers if self.cfg.moe else 0

    @property
    def n_stacked(self) -> int:
        return self.cfg.n_layers - self.n_front

    @property
    def device(self) -> torch.device:
        return self.params["final_norm"]["gamma"].device

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.dtype)

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

    def leaf(self, path: tuple):
        """The parameter at a path of the reference's tree; a
        ``"layers"`` path names a stacked leaf and gives the list of its
        per-layer parameters."""
        def walk(t, keys):
            for k in keys:
                t = t[k]
            return t
        if path[0] == "layers":
            return [walk(layer, path[1:]) for layer in self.params["layers"]]
        return walk(self.params, path)

    def init(self, generator: torch.Generator) -> "TransformerLM":
        """Draw every parameter from ``generator`` (on the model's device),
        leaf by leaf in the tree's order, each stacked leaf layer by layer,
        with the reference's init rule (``P.std`` of the stacked leaf)."""
        for path, p in leaves(self.decls()):
            t = self.leaf(path)
            for x in t if path[0] == "layers" else [t]:
                init_leaf(x, p, generator)
        return self

    def abstract(self, dtype: torch.dtype | None = None):
        """The reference's parameter tree as ``meta`` tensors."""
        return abstract(self.decls(), dtype)

    def n_params(self) -> int:
        return count_params(self.decls())

    # -- blocks --------------------------------------------------------------
    def _block(self, p, x: torch.Tensor, positions: torch.Tensor, *,
               moe_layer: bool, cache: dict | None = None,
               fill_len: int | None = None):
        cfg = self.cfg
        h, new_cache = attn_forward(p["attn"], _norm(p["ln1"], x, cfg),
                                    positions, cfg, cache=cache,
                                    fill_len=fill_len)
        x = x + h
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if moe_layer:
            h, aux = moe_forward(p["moe"], _norm(p["ln2"], x, cfg), cfg)
        else:
            h = mlp_forward(p["mlp"], _norm(p["ln2"], x, cfg), cfg.act)
        return x + h, aux, new_cache

    # -- embedding / head ----------------------------------------------------
    def embed(self, tokens: torch.Tensor,
              extra_embeds: torch.Tensor | None = None) -> torch.Tensor:
        """Token embeddings in the compute dtype: audio codebooks summed,
        tied embeddings scaled by sqrt(d), vlm patch embeddings
        (``extra_embeds`` (B, S_img, d)) prepended to the text."""
        cfg = self.cfg
        emb = self.params["embed"]
        tokens = tokens.long()
        if cfg.modality == "audio" and cfg.n_codebooks > 1:
            x = sum(F.embedding(tokens[..., c], emb[c])
                    for c in range(cfg.n_codebooks))
        else:
            x = F.embedding(tokens, emb)
        x = x.to(self.compute_dtype)
        if cfg.tie_embeddings:
            x = x * math.sqrt(cfg.d_model)
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and head -> f32 logits (B, S, V), or (B, S, C, V)
        for the audio codebooks."""
        cfg = self.cfg
        x = _norm(self.params["final_norm"], x, cfg)
        if cfg.tie_embeddings:
            out = x @ self.params["embed"].to(x.dtype).T
        elif cfg.modality == "audio" and cfg.n_codebooks > 1:
            out = torch.einsum("bsd,cdv->bscv", x,
                               self.params["lm_head"].to(x.dtype))
        else:
            out = x @ self.params["lm_head"].to(x.dtype)
        return out.to(torch.float32)

    # -- full forward ---------------------------------------------------------
    @torch.no_grad()
    def hidden(self, tokens: torch.Tensor, positions: torch.Tensor,
               extra_embeds: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (final hidden states (B, S, d) before the final norm, aux
        loss): the stack ``forward`` and ``prefill`` run."""
        x = self.embed(tokens, extra_embeds)
        for p in self.params["front"] if "front" in self.params else ():
            x, _, _ = self._block(p, x, positions, moe_layer=False)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        moe_layer = self.cfg.moe is not None
        for p in self.params["layers"]:
            x, a, _ = self._block(p, x, positions, moe_layer=moe_layer)
            aux = aux + a
        return x, aux

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                extra_embeds: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (logits, aux_loss)."""
        x, aux = self.hidden(tokens, positions, extra_embeds)
        return self.logits(x), aux

    # -- loss ----------------------------------------------------------------
    @torch.no_grad()
    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Next-token CE + z-loss + MoE aux, as a value.  batch: tokens
        (B, S[, C]), optional loss_mask, positions, extra_embeds."""
        tokens = batch["tokens"]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]
        logits, aux = self.forward(tokens, positions,
                                   batch.get("extra_embeds"))
        if batch.get("extra_embeds") is not None:
            logits = logits[:, -tokens.shape[1]:]    # text positions only
        targets = tokens[:, 1:].long()
        logits = logits[:, :-1]
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = mask[:, 1:].to(torch.float32)
            if nll.ndim == 3:                        # audio codebooks
                mask = mask[..., None]
            ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        else:
            ce = nll.mean()
        # z-loss keeps the softmax normalizer bounded (stability at scale).
        zl = 1e-4 * torch.square(torch.logsumexp(logits, dim=-1)).mean()
        return ce + zl + aux, {"ce": ce, "aux": aux, "zloss": zl}

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        """{"layers": {name: (L, ...)}, "front": [one layer's, ...]}, the
        reference's layout: each stacked leaf has a leading layer axis."""
        one = lambda: init_attn_cache(self.cfg, batch, max_len, dtype,
                                      self.device)
        cache = {"layers": {k: torch.stack([v] * self.n_stacked)
                            for k, v in one().items()}}
        if self.n_front:
            cache["front"] = [one() for _ in range(self.n_front)]
        return cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, positions: torch.Tensor,
                max_len: int, extra_embeds: torch.Tensor | None = None):
        """Process a full prompt -> (last-position logits, cache padded to
        max_len)."""
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
        return self.logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """One decode step: tokens (B, 1[, C]) -> (logits (B, 1, V[, C]),
        cache).  The cache is updated in place and returned."""
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

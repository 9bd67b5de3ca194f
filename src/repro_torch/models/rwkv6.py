"""RWKV6 "Finch", the attention-free LM with data-dependent decay (the
port of ``repro.models.rwkv6`` as an ``nn.Module``: ``hidden`` /
``forward`` / ``loss`` differentiable, each block under ``remat`` when
the config sets it; ``prefill`` / ``decode_step`` under ``no_grad``).

Per arXiv:2404.05892: token-shift ddlerp mixes with a shared LoRA, a
data-dependent per-channel decay ``w_t = exp(-exp(w0 + lora))``, the
u-bonus for the current token, a per-head group norm and a squared-ReLU
channel mix.  The wkv recurrence runs on the shared chunked engine
(``ssm_common``): ``chunked_la`` for forward and prefill, the O(1)-state
``la_step`` for decode.  The heads are ``d_model / head_dim`` wide, not
``cfg.n_heads``.

The cache is the recurrent state, O(1) in the sequence length:
{"layers": {"x_tm": (L, B, d) bf16, "x_cm": (L, B, d) bf16, "s": (L, B,
H, hd, hd) f32}}.  ``decode_step`` writes the new state into the cache
it is given (the reference returns a new one).  Prefill rounds the
token-shift carries to bf16; decode hands them back in the compute
dtype, as the reference's does, so an f32 model's first decode step
widens those two leaves (a new tensor in the same cache dict) and every
later step writes in place.

Built with a ``ShardCtx`` on a mesh it is tensor parallel (``StackedLM``;
the reference's constraint points ``rwkv6.py:158,174,183,187,195,208``):
the residual stream between layers holds this rank's rows and, where the
sequence divides the model axis, its positions.  Each mix takes its
layer norm on those positions and all-gathers the sequence (the token
shift needs the neighbouring rank's last position).  The time mix's
``wr`` / ``wk`` / ``wv`` / ``wg``, ``u`` and ``ln_x`` are this rank's
heads, its decay is taken for those heads only, and ``wo`` is
row-parallel; the channel mix's ``wk`` is column-parallel and ``wv``
row-parallel, and its gate ``sigmoid(xr @ cm.wr)`` is taken on this
rank's positions.  The shared lora, ``w0`` / ``wa`` / ``wb`` and
``cm.wr`` are whole.  The embedding is a vocab-parallel lookup, the
logits stay vocab-sharded and the loss is vocab parallel; the cache's
``s`` is this rank's heads, ``x_tm`` / ``x_cm`` are whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..numerics import rsqrt_rn
from .base import (NULL_CTX, P, ShardCtx, StackedLM, dense, dense_out,
                   layer_norm, model_split, sigmoid, silu)
from .ssm_common import chunked_la, la_step
from .transformer import _stack

F32 = torch.float32
N_MIX = 5  # r, w, k, v, g ddlerp streams
LORA_RANK = 32


def _shift(x: torch.Tensor, x_prev: torch.Tensor | None) -> torch.Tensor:
    """Token shift: the previous token's features (zeros, or the carried
    ``x_prev`` (B, d), at t = 0)."""
    pad = (torch.zeros_like(x[:, :1]) if x_prev is None
           else x_prev[:, None, :].to(x.dtype))
    return torch.cat([pad, x[:, :-1]], dim=1)


class RWKV6LM(StackedLM):
    """RWKV6 of one config on one device, or tensor parallel on a mesh
    (``StackedLM``)."""

    def __init__(self, cfg, ctx: ShardCtx = NULL_CTX, *,
                 device: str | torch.device | None = None):
        if cfg.ssm is None or cfg.ssm.kind != "rwkv6":
            raise ValueError(f"{cfg.name} is not an rwkv6 config")
        self.head_dim = cfg.ssm.head_dim
        self.n_heads_ssm = cfg.d_model // self.head_dim
        super().__init__(cfg, ctx, device=device)

    # -- declarations --------------------------------------------------------
    def _block_decls(self) -> dict:
        cfg = self.cfg
        d, ff = cfg.d_model, cfg.d_ff
        H, hd = self.n_heads_ssm, self.head_dim
        lr, lw = LORA_RANK, cfg.ssm.decay_lora
        ln = lambda: {"gamma": P((d,), (None,), init="ones"),
                      "beta": P((d,), (None,), init="zeros")}
        return {
            "ln1": ln(),
            "ln2": ln(),
            "tm": {
                "mu_x": P((d,), (None,), init="zeros"),
                "mu": P((N_MIX, d), (None, None), init="zeros"),
                "lora_a": P((d, N_MIX * lr), ("embed", None), scale=0.02),
                "lora_b": P((N_MIX, lr, d), (None, None, "embed"),
                            scale=0.02),
                "w0": P((d,), (None,), init="zeros"),
                "wa": P((d, lw), ("embed", None), scale=0.02),
                "wb": P((lw, d), (None, "embed"), scale=0.02),
                "wr": P((d, H, hd), ("embed", "heads", None)),
                "wk": P((d, H, hd), ("embed", "heads", None)),
                "wv": P((d, H, hd), ("embed", "heads", None)),
                "wg": P((d, H, hd), ("embed", "heads", None)),
                "u": P((H, hd), ("heads", None), init="small"),
                "ln_x": {"gamma": P((H, hd), ("heads", None), init="ones"),
                         "beta": P((H, hd), ("heads", None), init="zeros")},
                "wo": P((H, hd, d), ("heads", None, "embed")),
            },
            "cm": {
                "mu_k": P((d,), (None,), init="zeros"),
                "mu_r": P((d,), (None,), init="zeros"),
                "wk": P((d, ff), ("embed", "mlp")),
                "wv": P((ff, d), ("mlp", "embed")),
                "wr": P((d, d), ("embed", None)),
            },
        }

    def decls(self) -> dict:
        cfg = self.cfg
        ln = lambda: {"gamma": P((cfg.d_model,), (None,), init="ones"),
                      "beta": P((cfg.d_model,), (None,), init="zeros")}
        return {
            "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       scale=1.0),
            "ln0": ln(),
            "final_norm": ln(),
            "lm_head": P((cfg.d_model, cfg.vocab), ("embed", "vocab")),
            "layers": _stack(self._block_decls(), cfg.n_layers),
        }

    # -- time mix -------------------------------------------------------------
    def _time_mix_proj(self, tm, x: torch.Tensor, xx: torch.Tensor):
        """The ddlerp's five mixed streams, then r, k, v, the gate and the
        f32 log decay (B, S, H, hd); on a mesh whose rules split the heads,
        this rank's heads of each."""
        B, S, d = x.shape
        hd = self.head_dim
        H = tm["wr"].shape[1]                       # this rank's heads
        w0, wb = tm["w0"], tm["wb"]
        if model_split(tm, "wr", 1):                # their decay columns
            lo = self.ctx.model_rank * H * hd
            w0, wb = w0.narrow(0, lo, H * hd), wb.narrow(1, lo, H * hd)
        base = x + xx * tm["mu_x"].to(x.dtype)
        s = torch.tanh(dense(base, tm["lora_a"])).reshape(B, S, N_MIX, -1)
        s = torch.einsum("bsml,mld->bsmd", s, tm["lora_b"].to(x.dtype))
        mixed = x[:, :, None, :] + xx[:, :, None, :] * (
            tm["mu"].to(x.dtype) + s)
        x_r, x_w, x_k, x_v, x_g = mixed.unbind(2)
        r, k, v = dense(x_r, tm["wr"]), dense(x_k, tm["wk"]), dense(
            x_v, tm["wv"])
        g = silu(dense(x_g, tm["wg"]))
        lora = (x_w.to(F32) @ tm["wa"].to(F32)) @ wb.to(F32)
        log_w = -torch.exp(w0.to(F32) + lora).reshape(B, S, H, hd)
        return r, k, v, g, log_w

    def _time_mix_out(self, tm, o: torch.Tensor, g: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
        """Per-head group norm (population variance) and ``ln_x`` in f32,
        then the cast, the gate and the output projection."""
        o32 = o.to(F32)
        mu = o32.mean(-1, keepdim=True)
        var = o32.var(-1, keepdim=True, correction=0)
        o32 = (o32 - mu) * rsqrt_rn(var + 1e-5)
        o32 = o32 * tm["ln_x"]["gamma"] + tm["ln_x"]["beta"]
        return dense_out(o32.to(dtype) * g, tm["wo"])

    # -- blocks ---------------------------------------------------------------
    def _block(self, p, x: torch.Tensor, state: dict | None, S: int):
        """-> (x, new state {"x_tm", "x_cm", "s"}); ``state`` None is a
        full sequence of ``S`` (prefill), else one token against that
        state.  On a mesh ``x`` is at the layer boundary's layout."""
        ctx = self.ctx
        tm, cm = p["tm"], p["cm"]
        new_state = {}

        xn = ctx.gather_seq(layer_norm(x, p["ln1"]["gamma"],
                                       p["ln1"]["beta"]), S)
        xx = _shift(xn, None if state is None else state["x_tm"]) - xn
        r, k, v, g, log_w = self._time_mix_proj(tm, xn, xx)
        u = tm["u"].to(F32)
        if state is None:
            o, new_state["s"] = chunked_la(r, k, v, log_w, u=u,
                                           inclusive=False,
                                           chunk=self.cfg.ssm.chunk)
        else:
            o1, new_state["s"] = la_step(state["s"], r[:, 0], k[:, 0],
                                         v[:, 0], log_w[:, 0], u=u,
                                         inclusive=False)
            o = o1[:, None]
        new_state["x_tm"] = xn[:, -1].clone()   # not a view of (B, S, d)
        x = x + ctx.scatter_seq(self._time_mix_out(tm, o, g, x.dtype),
                                model_split(tm, "wo", 0))

        xn = ctx.gather_seq(layer_norm(x, p["ln2"]["gamma"],
                                       p["ln2"]["beta"]), S)
        xx = _shift(xn, None if state is None else state["x_cm"]) - xn
        xk = xn + xx * cm["mu_k"].to(x.dtype)
        xr = ctx.scatter_seq(xn + xx * cm["mu_r"].to(x.dtype), False)
        h = torch.square(F.relu(dense(xk, cm["wk"])))
        out = sigmoid(dense(xr, cm["wr"])) * ctx.scatter_seq(
            dense(h, cm["wv"]), model_split(cm, "wv", 0))
        new_state["x_cm"] = xn[:, -1].clone()
        return x + out, new_state

    # -- LM interface ---------------------------------------------------------
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings in the compute dtype, through ``ln0``: the
        first block's input.  On a mesh a vocab-parallel lookup
        (``StackedLM.lookup``) reduce-scattered to the layer boundary's
        layout, then ``ln0`` on this rank's positions."""
        x = self.lookup(tokens.long(), self.params["embed"]).to(
            self.compute_dtype)
        x = self.ctx.scatter_seq(x, self._vocab() is not None)
        return layer_norm(x, self.params["ln0"]["gamma"],
                          self.params["ln0"]["beta"])

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final layer norm and head -> f32 logits; on a mesh ``x`` is
        whole over the sequence and the logits are this rank's vocab
        block (``gather_vocab`` assembles them)."""
        x = layer_norm(x, self.params["final_norm"]["gamma"],
                       self.params["final_norm"]["beta"])
        return (x @ self.params["lm_head"].to(x.dtype)).to(F32)

    def hidden(self, tokens: torch.Tensor, positions=None,
               extra_embeds=None, *, batch: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (final hidden states (B, S, d) before the final norm, a zero
        aux loss).  On a mesh the states are gathered whole over the
        sequence, and with ``batch`` (the global batch of which
        ``tokens`` are this rank's rows) over the rows too."""
        S = tokens.shape[1]
        x = self.embed(tokens)
        for p in self.params["layers"]:
            x, _ = self.remat(self._block, p, x, None, S)
        x = self.ctx.gather_seq(x, S)
        if batch is not None:
            x = self.ctx.gather_rows(x, batch)
        return x, torch.zeros((), dtype=F32, device=x.device)

    def forward(self, tokens: torch.Tensor, positions=None,
                extra_embeds=None) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (logits, aux_loss); on a mesh the logits are this rank's
        vocab block."""
        x, aux = self.hidden(tokens)
        return self.logits(x), aux

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Next-token CE + z-loss (``tokens`` only, as the reference's);
        on a mesh vocab parallel, the same value on every rank of the
        model axis."""
        logits, aux = self.forward(batch["tokens"])
        ce, zl = self.token_loss(logits, batch["tokens"])
        return ce + zl, {"ce": ce, "aux": aux, "zloss": zl}

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int = 0,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        """The recurrent state, O(1) in the sequence length (``max_len``
        unused); on a mesh ``batch`` rows of this rank's blocks under
        ``cache_axes``."""
        L, d = self.cfg.n_layers, self.cfg.d_model
        H, hd = self.n_heads_ssm, self.head_dim
        axes = self.cache_axes()["layers"]
        z = lambda k, shape, dt: torch.zeros(
            self.ctx.model_block(shape, axes[k]), dtype=dt, device=self.device)
        return {"layers": dict(
            x_tm=z("x_tm", (L, batch, d), dtype),
            x_cm=z("x_cm", (L, batch, d), dtype),
            s=z("s", (L, batch, H, hd, hd), F32))}

    def cache_axes(self) -> dict:
        return {"layers": dict(
            x_tm=("layers", "batch", None),
            x_cm=("layers", "batch", None),
            s=("layers", "batch", "heads", None, None))}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, positions=None,
                max_len: int = 0, extra_embeds=None):
        """Full-prompt pass -> (last-position logits, recurrent cache).
        On a mesh the tokens are this rank's rows, the logits its vocab
        block and the cache its blocks under ``cache_axes``."""
        S = tokens.shape[1]
        x = self.embed(tokens)
        states = []
        for p in self.params["layers"]:
            x, st = self._block(p, x, None, S)
            states.append(st)
        cache = {"layers": {k: torch.stack([st[k] for st in states])
                            for k in ("x_tm", "x_cm", "s")}}
        for k in ("x_tm", "x_cm"):
            cache["layers"][k] = cache["layers"][k].to(torch.bfloat16)
        return self.logits(self.last_position(x, S)), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    positions=None) -> tuple[torch.Tensor, dict]:
        """One token: tokens (B, 1) -> (logits (B, 1, V), cache).  The
        cache is updated in place and returned.  On a mesh as
        ``prefill``."""
        x = self.embed(tokens)
        lay = cache["layers"]
        for i, p in enumerate(self.params["layers"]):
            x, st = self._block(p, x, {k: v[i] for k, v in lay.items()}, 1)
            for k, v in st.items():
                if lay[k].dtype != v.dtype:
                    lay[k] = lay[k].to(v.dtype)
                lay[k][i] = v
        return self.logits(x), cache

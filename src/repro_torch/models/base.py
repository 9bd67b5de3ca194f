"""Model substrate: declarative parameter trees and the functional layers
(the port of ``repro.models.base``).

Every model declares its parameters as a nested dict (and list) of ``P``
leaves (shape, logical axes, init), the reference's declarations leaf for
leaf.  From one declaration tree come:

* ``ParamTree``      — an ``nn.Module`` holding one ``Parameter`` a leaf,
  named by the tree's keys (``params.layers.3.attn.wq``);
* ``init_leaf``      — fills a parameter from a ``torch.Generator``;
* ``abstract``       — the tree as tensors on the ``meta`` device: a full
  config is counted and sized without allocating anything;
* ``axes_tree`` / ``count_params``.

``StackedLM`` is what the LM families share: the parameters of the
declaration tree with its stacked ``"layers"`` axis unstacked into an
``nn.ModuleList``, the leaf lookup, the seeded init and the counts, the
reference's tree of tensors (``tree`` / ``load_tree``), running on an
explicit tree (``bound``, what the train step does) and ``remat``.

The logical axes ("embed", "heads", "kv", "mlp", "experts", "layers", ...)
are the reference's.  ``ShardCtx`` resolves them to mesh layouts
(``sharding.layout.Sharding``) through a rule table
(``sharding.rules``): the ZeRO train step (``train.step``) lays out the
parameters, moments and gradients by them.  A model keeps its ctx
(``build(cfg, ctx)``).  A ``StackedLM`` of any family (transformer,
rwkv6, zamba2) built on a mesh is tensor parallel: it holds each weight
as this rank's block over the ``"model"`` axis and computes on the
blocks.  Its layers move their activations at the reference's
constraint points with the explicit collectives of ``sharding.layout``
(``ShardCtx.gather_seq`` / ``scatter_seq`` and the legs in
``attention.py`` / ``ffn.py`` / ``mamba2.py``); the embedding is a
vocab-parallel lookup, the logits stay vocab-sharded and the loss takes
a vocab-parallel log-softmax (``StackedLM``).  Every method then takes
and returns this rank's batch rows.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Iterator

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..device import resolve_device
from ..launch.mesh import axis_sizes
from ..numerics import rsqrt_rn
from ..sharding.layout import (Sharding, all_gather_axis, all_reduce_axis,
                               all_reduce_max, entry_names,
                               reduce_scatter_axis)
from .config import torch_dtype

Tree = Any


@dataclasses.dataclass(frozen=True)
class P:
    """Declaration of one parameter tensor."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]      # logical axis names, len == ndim
    dtype: torch.dtype = torch.float32
    init: str = "normal"              # normal | zeros | ones | small
    scale: float | None = None        # stddev override for "normal"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             f"in rank")

    @property
    def std(self) -> float:
        """The normal init's standard deviation: ``scale``, else 1/sqrt of
        the fan-in (``shape[-2]``, or ``shape[-1]`` for a vector), 0.02 for
        ``"small"`` (the reference's rule, applied to its stacked shapes)."""
        if self.init == "small":
            return 0.02
        if self.scale is not None:
            return self.scale
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        return 1.0 / math.sqrt(fan_in)


def leaves(tree: Tree, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs in the reference's flattening order: dict keys
    sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def tree_map(fn: Callable, tree: Tree, path: tuple = (),
             with_path: bool = False) -> Tree:
    """``fn(leaf)`` (or ``fn(path, leaf)``) over a tree of dicts and
    lists, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,), with_path)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, path + (i,), with_path)
                for i, v in enumerate(tree)]
    return fn(path, tree) if with_path else fn(tree)


def unflatten(like: Tree, flat: list) -> Tree:
    """The inverse of ``leaves``: ``like``'s structure over the values of
    ``flat``, taken in ``leaves`` order (dict keys sorted)."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)
    return build(like)


def _walk(tree, keys: tuple):
    for k in keys:
        tree = tree[k]
    return tree


def count_params(decls: Tree) -> int:
    return sum(math.prod(p.shape) for _, p in leaves(decls))


def axes_tree(decls: Tree) -> Tree:
    """The logical-axis tree, same structure as the parameters."""
    return tree_map(lambda p: p.axes, decls)


def abstract(decls: Tree, dtype: torch.dtype | None = None) -> Tree:
    """Tensors on the ``meta`` device in place of the parameters: shapes
    and dtypes, nothing allocated."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=dtype or p.dtype,
                                          device="meta"), decls)


# ---------------------------------------------------------------------------
# Sharding context
# ---------------------------------------------------------------------------

class ShardCtx:
    """Resolves logical axes to mesh layouts (the port of the reference's
    ``ShardCtx``).

    ``mesh=None`` (one device) makes every method a no-op.  A logical axis
    maps to the mesh axes its rule names only where they divide the dim
    evenly; otherwise, or when one of those mesh axes is already used by
    an earlier dim, that dim is whole on every rank.  So one table serves
    every architecture (kv = 2 GQA heads on a model axis of 16 fall back
    to ``head_dim``), and a batch of one is never split.  Sizes are read
    through ``launch.mesh.axis_sizes``: a ``DeviceMesh``, or any object
    whose ``shape`` maps axis names to sizes.
    """

    def __init__(self, mesh, rules: dict[str, Any] | None = None):
        self.mesh = mesh
        self.rules = rules or {}

    def _axis_size(self, entry) -> int:
        sizes = axis_sizes(self.mesh)
        return math.prod(sizes.get(a, 1) for a in entry_names(entry))

    def spec(self, shape: tuple[int, ...],
             axes: tuple[str | None, ...]) -> tuple:
        """One entry a dim (the reference's ``PartitionSpec`` entries):
        ``None``, a mesh axis name, or a tuple of names; ``()`` without a
        mesh."""
        if self.mesh is None:
            return ()
        entries, used = [], set()
        for dim, ax in zip(shape, axes):
            entry = self.rules.get(ax) if ax else None
            if entry is not None and any(a in used
                                         for a in entry_names(entry)):
                entry = None
            if entry is not None and dim % self._axis_size(entry) != 0:
                entry = None
            used.update(entry_names(entry))
            if isinstance(entry, tuple) and len(entry) == 1:
                entry = entry[0]     # as PartitionSpec spells it
            entries.append(entry)
        return tuple(entries)

    def sharding(self, shape, axes) -> Sharding | None:
        """The layout of a ``shape`` tensor with logical ``axes`` (the
        counterpart of ``NamedSharding``); None without a mesh."""
        if self.mesh is None:
            return None
        return Sharding(self.mesh, self.spec(tuple(shape), tuple(axes)))

    def constrain(self, x, *axes: str | None):
        """Lay ``x`` out by ``axes``: a DTensor is redistributed to the
        spec's placements; a plain tensor, or any tensor without a mesh,
        is returned as it is.  The tensor-parallel models hold their
        activations as plain local shards and move them at the
        reference's constraint points with explicit collectives
        (``gather_seq`` / ``scatter_seq``, ``sharding.layout``): DTensor
        has no sharding strategy for the MoE dispatch's argsort /
        scatter_add / gather, and three of the reference's four mesh
        mechanisms are explicit ``shard_map`` s."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            return x.redistribute(self.mesh, self.sharding(
                x.shape, axes).placements)
        return x

    def param_shardings(self, decls: Tree) -> Tree:
        """A ``Sharding`` (None without a mesh) for every leaf of a
        declaration tree."""
        return tree_map(lambda p: self.sharding(p.shape, p.axes), decls)

    # -- what the tensor-parallel layers read ------------------------------
    @property
    def sizes(self) -> dict[str, int]:
        return {} if self.mesh is None else axis_sizes(self.mesh)

    @property
    def model_size(self) -> int:
        """The size of the ``"model"`` axis (1 without a mesh)."""
        return self.sizes.get("model", 1)

    @property
    def data_axes(self) -> tuple[str, ...]:
        """The mesh's data axes, ``("pod", "data")`` or ``("data",)``."""
        return tuple(a for a in ("pod", "data") if a in self.sizes)

    def coordinate(self) -> dict[str, int]:
        """Axis name -> this rank's index on it (empty without a mesh)."""
        if self.mesh is None:
            return {}
        return dict(zip(self.sizes, (int(c) for c in
                                     self.mesh.get_coordinate())))

    @property
    def model_rank(self) -> int:
        return self.coordinate().get("model", 0)

    def shards(self, n: int, axis: str) -> bool:
        """Whether a dim of ``n`` with the logical axis ``axis`` (leading,
        no earlier dim on the model axis) is split over ``"model"``."""
        m = self.model_size
        return (m > 1 and "model" in entry_names(self.rules.get(axis))
                and n % m == 0)

    def model_spec(self, shape, axes) -> tuple:
        """``spec`` with only its ``"model"`` entries: the block a
        tensor-parallel model holds (whole over the data axes)."""
        return tuple("model" if "model" in entry_names(e) else None
                     for e in self.spec(tuple(shape), tuple(axes)))

    def model_block(self, shape, axes) -> tuple[int, ...]:
        """The shape of this rank's block (``model_spec``) of a ``shape``
        tensor with logical ``axes``; ``shape`` without a mesh."""
        if self.mesh is None:
            return tuple(shape)
        return Sharding(self.mesh, self.model_spec(shape, axes)).shard_shape(
            shape)

    def local(self, x: torch.Tensor, *axes: str | None) -> torch.Tensor:
        """This rank's block (a view) of the full tensor ``x`` laid out by
        the logical ``axes``; ``x`` without a mesh."""
        if self.mesh is None:
            return x
        return self.sharding(x.shape, axes).local(x)

    def seq_split(self, S: int) -> bool:
        """Whether a sequence of ``S`` positions is split over the model
        axis at the layer boundaries (``act_rules``' ``"seq"``)."""
        return self.shards(S, "seq")

    def gather_seq(self, x: torch.Tensor, S: int) -> torch.Tensor:
        """The sequence-parallel all-gather: this rank's positions of a
        sequence of ``S`` (dim 1) -> all ``S`` of them, on every rank of
        the model axis."""
        if not self.seq_split(S):
            return x
        return all_gather_axis(x, self.mesh, "model", 1)

    def scatter_seq(self, y: torch.Tensor, partial: bool) -> torch.Tensor:
        """``y`` (B, S, ...) whole over the sequence to the layer
        boundary's layout ``("batch", "seq", None)``: a partial sum over
        the model axis (a row-parallel product's output) is
        reduce-scattered, or all-reduced where S does not split; a tensor
        every model rank holds in full is cut to this rank's positions."""
        if self.mesh is None:
            return y
        S = y.shape[1]
        if self.seq_split(S):
            if partial:
                return reduce_scatter_axis(y, self.mesh, "model", 1)
            n = S // self.model_size
            return y.narrow(1, self.model_rank * n, n)
        return all_reduce_axis(y, self.mesh, "model") if partial else y

    def as_partial(self, y: torch.Tensor) -> torch.Tensor:
        """A tensor every model rank holds in full, as a partial sum over
        the model axis (itself on model rank 0, zeros on the others), to
        add to a row-parallel product's output."""
        return y if self.model_rank == 0 else torch.zeros_like(y)

    def mean_data(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the data axes (the reference's ``pmean``
        over them)."""
        n = math.prod(self.sizes[a] for a in self.data_axes)
        if n == 1:
            return x
        return all_reduce_axis(x, self.mesh, self.data_axes) / n

    def gather_rows(self, x: torch.Tensor, batch: int) -> torch.Tensor:
        """This rank's rows (dim 0) of a batch of ``batch`` rows laid out
        by ``"batch"`` -> all of them."""
        if self.mesh is None:
            return x
        entry = self.spec((batch,), ("batch",))[0]
        for a in reversed(entry_names(entry)):
            x = all_gather_axis(x, self.mesh, a, 0)
        return x


NULL_CTX = ShardCtx(None)


class ParamTree(nn.Module):
    """The parameters of a declaration tree: a ``P`` leaf is a
    ``Parameter`` (``requires_grad=False``: serving builds no autograd
    graph; training differentiates an explicit f32 master tree that
    ``StackedLM.bound`` puts in place of the parameters, as the
    reference's ``loss(params, batch)`` takes its tree), a dict a child
    ``ParamTree`` and a list an ``nn.ModuleList``.  Indexing
    by key reads like the reference's parameter dicts: ``p["wq"]``,
    ``"w_gate" in p``."""

    def __init__(self, decls: dict, device: torch.device,
                 dtype: torch.dtype | None = None, specs: dict | None = None):
        super().__init__()
        # name -> the spec of this rank's block over the model axis, for
        # each parameter of a tensor-parallel model (``model_split``)
        self.specs = {}
        for name, d in decls.items():
            s = None if specs is None else specs[name]
            if isinstance(d, P):
                if s is not None:
                    self.specs[name] = s
                self.register_parameter(name, nn.Parameter(
                    torch.empty(d.shape, dtype=dtype or d.dtype,
                                device=device), requires_grad=False))
            elif isinstance(d, dict):
                self.add_module(name, ParamTree(d, device, dtype, s))
            else:
                self.add_module(name, nn.ModuleList(
                    ParamTree(x, device, dtype, None if s is None else s[i])
                    for i, x in enumerate(d)))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def model_split(p, name: str, dim: int) -> bool:
    """Whether parameter ``name`` of the ``ParamTree`` ``p`` is this
    rank's block over the model axis along ``dim`` (False on one device,
    or for a plain dict of tensors)."""
    spec = p.specs.get(name) if isinstance(p, ParamTree) else None
    return spec is not None and spec[dim] == "model"


def init_leaf(t: torch.Tensor, p: P, generator: torch.Generator) -> None:
    """Fill ``t`` in place with ``p``'s init, drawing from ``generator``
    (normal draws are made in f32, as the reference's)."""
    with torch.no_grad():
        if p.init == "zeros":
            t.zero_()
        elif p.init == "ones":
            t.fill_(1.0)
        elif t.dtype == torch.float32:
            t.normal_(0.0, p.std, generator=generator)
        else:
            t.copy_(torch.empty(t.shape, dtype=torch.float32,
                                device=t.device).normal_(
                0.0, p.std, generator=generator))


# ---------------------------------------------------------------------------
# Functional layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Mixed-precision RMSNorm: the variance reduction runs in f32, the
    data path stays in x.dtype; scales by ``1 + gamma`` (gamma starts at
    zero)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = rsqrt_rn(var + eps).to(x.dtype)
    return x * inv * (1.0 + gamma.to(x.dtype))


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    inv = rsqrt_rn(var + eps).to(x.dtype)
    out = (x - mu.to(x.dtype)) * inv
    return out * gamma.to(x.dtype) + beta.to(x.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` in x's dtype.  In bf16 XLA expands it into
    ``1 / (1 + exp(-x))`` with each step rounded, and so does this (bit
    for bit; ``torch.sigmoid`` rounds once, a bf16 ulp off in a third of
    the lanes); in f32 ``torch.sigmoid``, within an ulp."""
    if x.dtype == torch.bfloat16:
        return 1.0 / (1.0 + torch.exp(-x))
    return torch.sigmoid(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x), the sigmoid rounded first."""
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` step for step in x's dtype, its
    constants rounded to that dtype (bit for bit in bf16, where
    ``F.gelu`` rounds once)."""
    c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
    inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": silu,
    "gelu": gelu_tanh,
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
}


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, ...) -> (..., *w.shape[1:]) in x.dtype: the
    weight is cast to x.dtype and the product rounds once (a bf16 GEMM
    accumulates in f32), as the reference's ``dot_general``."""
    out = x @ w.reshape(w.shape[0], -1).to(x.dtype)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def dense_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, k) @ w (H, k, d) -> (B, S, d): the heads' output
    projection (the reference's ``einsum("bshk,hkd->bsd")``)."""
    B, S = x.shape[:2]
    return (x.reshape(B, S, -1)
            @ w.reshape(-1, w.shape[-1]).to(x.dtype))


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    mask: torch.Tensor | None = None,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean next-token CE over ``mask`` (all positions without one),
    z-loss) of f32 ``logits`` (B, S, [C,] V) on ``tokens`` (B, S[, C])."""
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return loss_terms(nll, torch.logsumexp(logits, dim=-1), mask)


def loss_terms(nll: torch.Tensor, lse: torch.Tensor,
               mask: torch.Tensor | None = None,
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(the mean of the next-token ``nll`` (B, S - 1[, C]) over ``mask``
    (B, S) (all positions without one), the z-loss of the softmax
    normalizers ``lse``): the tail of ``next_token_loss`` and of the
    vocab-parallel loss (``StackedLM.token_loss``)."""
    if mask is not None:
        mask = mask[:, 1:].to(torch.float32)
        if nll.ndim == 3:                            # audio codebooks
            mask = mask[..., None]
        ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        ce = nll.mean()
    # z-loss keeps the softmax normalizer bounded (stability at scale).
    zl = 1e-4 * torch.square(lse).mean()
    return ce, zl


class StackedLM(nn.Module):
    """An LM of one config on one device whose declarations (``decls``,
    the reference's tree) stack the repeated layers on a leading
    ``"layers"`` axis.  The parameters live in ``self.params``, a
    ``ParamTree`` of that tree with ``"layers"`` unstacked into an
    ``nn.ModuleList`` (``params.layers.3.attn.wq`` is the reference's
    ``params["layers"]["attn"]["wq"][3]``); every weight keeps the
    reference's layout, so converting a tree is a copy
    (``repro_torch.convert.lm_params_from_arrays``).  Built with
    ``device=None`` it lives on ``cuda`` (raising without a card);
    ``"meta"`` allocates nothing.  Parameters start uninitialized: fill
    them with ``init`` or copy them in.

    Built with a ``ctx`` on a mesh it is tensor parallel: each parameter
    is this rank's block under ``ctx.model_spec`` (the ``"model"``
    entries of ``ctx.spec``: whole over the data axes), ``init`` draws
    each full leaf as one device does and keeps the block, ``load_tree``
    / ``bound`` take a leaf at its full shape (and keep its block) or at
    the block's, and ``tree`` gives the blocks.  The vocab-parallel
    pieces every family shares live here: the embedding lookup
    (``lookup``), ``gather_vocab``, the next-token loss (``token_loss``)
    and the prefill's last position (``last_position``)."""

    def __init__(self, cfg, ctx: ShardCtx = NULL_CTX, *,
                 device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        self.ctx = ctx
        dev = resolve_device(device)
        decls = self.decls()
        self.tp = ctx.mesh is not None
        # leaf path -> Sharding of this rank's block (tensor parallel)
        self._blocks = ({path: Sharding(ctx.mesh, ctx.model_spec(
            p.shape, p.axes)) for path, p in leaves(decls)}
            if self.tp else {})

        def local(path, p):
            if not self.tp:
                return p
            return P(self._blocks[path].shard_shape(p.shape), p.axes,
                     p.dtype, p.init, p.scale)
        decls = tree_map(local, decls, with_path=True)
        specs = (tree_map(lambda path, _: self._blocks[path].spec, decls,
                          with_path=True) if self.tp else None)
        tree = {k: v for k, v in decls.items() if k != "layers"}
        n = next(leaves(decls["layers"]))[1].shape[0]
        one = tree_map(lambda p: P(p.shape[1:], p.axes[1:], p.dtype, p.init,
                                   p.scale), decls["layers"])
        tree["layers"] = [one] * n
        if specs is not None:       # a spec tuple is a leaf of tree_map
            specs = {k: v for k, v in specs.items() if k != "layers"} | {
                "layers": [tree_map(lambda sp: sp[1:], specs["layers"])] * n}
        self.params = ParamTree(tree, dev, torch_dtype(cfg.param_dtype),
                                specs)

    def decls(self) -> dict:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.dtype)

    # -- the vocab-parallel pieces ------------------------------------------
    def _vocab(self) -> tuple[int, int] | None:
        """(first vocab row, rows) of this rank's block of the embedding,
        None where the vocab is whole."""
        emb = self.params["embed"]
        dim = emb.ndim - 2
        if not model_split(self.params, "embed", dim):
            return None
        n = emb.shape[dim]
        return self.ctx.model_rank * n, n

    def lookup(self, tokens: torch.Tensor, table: torch.Tensor
               ) -> torch.Tensor:
        """``F.embedding(tokens, table)``; on a mesh whose rules split the
        vocab, ``table`` is this rank's vocab rows and the tokens outside
        them give zeros: a partial sum over the model axis with one
        nonzero term a position (so its sum is exact)."""
        vocab = self._vocab()
        if vocab is None:
            return F.embedding(tokens, table)
        lo, n = vocab
        i = tokens - lo
        hit = (i >= 0) & (i < n)
        return F.embedding(i.clamp(0, n - 1), table) * hit[..., None]

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Vocab-sharded logits -> whole over the vocab on every rank of
        the model axis (as they are without a mesh)."""
        if self._vocab() is None:
            return logits
        return all_gather_axis(logits, self.ctx.mesh, "model",
                               logits.ndim - 1)

    def last_position(self, x: torch.Tensor, S: int) -> torch.Tensor:
        """The last position (B, 1, ...) of ``x`` at the layer boundary's
        layout of a sequence of ``S``: where the sequence is split over
        the model axis, the last rank's last row, on every rank."""
        last = x[:, -1:]
        if self.ctx.seq_split(S):
            last = all_gather_axis(last, self.ctx.mesh, "model", 1)[:, -1:]
        return last

    def token_loss(self, logits: torch.Tensor, tokens: torch.Tensor,
                   mask: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """(CE, z-loss) of ``next_token_loss``; on a mesh whose rules
        split the vocab, of this rank's vocab block of the logits (the
        reference's ``transformer.py:192``): the max, the sum of
        exponentials and the target's logit each reduced over the model
        axis, so the (B, S, V) logits are never gathered.  The same
        value on every rank of the model axis."""
        vocab = self._vocab()
        if vocab is None:
            return next_token_loss(logits, tokens, mask)
        mesh = self.ctx.mesh
        targets = tokens[:, 1:].long()
        lg = logits[:, :-1]
        mx = all_reduce_max(lg.amax(dim=-1), mesh, "model")
        i = targets - vocab[0]
        hit = (i >= 0) & (i < lg.shape[-1])
        tgt = torch.gather(lg, -1, i.clamp(0, lg.shape[-1] - 1)[..., None]
                           )[..., 0] * hit
        se, tgt = all_reduce_axis(torch.stack(
            [torch.exp(lg - mx[..., None]).sum(dim=-1), tgt]), mesh,
            "model").unbind(0)
        lse = mx + torch.log(se)
        return loss_terms(lse - tgt, lse, mask)

    def leaf(self, path: tuple):
        """The parameter at a path of the reference's tree; a
        ``"layers"`` path names a stacked leaf and gives the list of its
        per-layer parameters."""
        if path[0] == "layers":
            return [_walk(layer, path[1:]) for layer in self.params["layers"]]
        return _walk(self.params, path)

    def init(self, generator: torch.Generator):
        """Draw every parameter from ``generator`` (on the model's device),
        leaf by leaf in the tree's order, each stacked leaf layer by layer,
        with the reference's init rule (``P.std`` of the stacked leaf).
        Tensor parallel, each layer's full leaf is drawn (the same values
        as on one device) and this rank's block kept."""
        for path, p in leaves(self.decls()):
            t = self.leaf(path)
            stacked = path[0] == "layers"
            shape = p.shape[1:] if stacked else p.shape
            for x in t if stacked else [t]:
                if tuple(x.shape) == shape:
                    init_leaf(x, p, generator)
                    continue
                full = torch.empty(shape, dtype=x.dtype, device=x.device)
                init_leaf(full, p, generator)
                spec = self._blocks[path].spec[1 if stacked else 0:]
                with torch.no_grad():
                    x.copy_(Sharding(self.ctx.mesh, spec).local(full))
                del full
        return self

    def tree(self) -> dict:
        """The reference's parameter tree as tensors on the model's
        device, ``"layers"`` stacked: a copy, detached from the module
        (tensor parallel: this rank's blocks)."""
        def get(path, _):
            t = self.leaf(path)
            if path[0] == "layers":
                return torch.stack([x.detach() for x in t])
            return t.detach().clone()
        return tree_map(get, self.decls(), with_path=True)

    def _slots(self, tree: Tree) -> Iterator[tuple[nn.Module, str, Any]]:
        """(module, parameter name, tensor) for each parameter, from a
        tree in the reference's layout: a stacked leaf is split into its
        layers (``unbind``).  Raises unless the tree's paths and shapes
        are the declarations' (tensor parallel: a leaf at its full shape
        gives its block, a view; or it is the block already)."""
        want = dict(leaves(self.decls()))
        got = list(leaves(dict(tree)))
        paths = {path for path, _ in got}
        if paths != set(want):
            raise ValueError(
                f"parameter tree differs from {self.cfg.name}'s "
                f"declarations: missing "
                f"{sorted(map(str, set(want) - paths))}, extra "
                f"{sorted(map(str, paths - set(want)))}")
        for i, (path, t) in enumerate(got):
            full = want[path].shape
            block = (self._blocks[path].shard_shape(full) if self.tp
                     else full)
            if tuple(t.shape) == full and block != full:
                got[i] = (path, self._blocks[path].local(t))
            elif tuple(t.shape) != block:
                raise ValueError(f"{path}: shape {tuple(t.shape)}, "
                                 f"declared {full}" + (
                                     f" (this rank's block {block})"
                                     if self.tp else ""))
        for path, t in got:
            if path[0] == "layers":
                for layer, x in zip(self.params["layers"], t.unbind(0)):
                    yield _walk(layer, path[1:-1]), path[-1], x
            else:
                yield _walk(self.params, path[:-1]), path[-1], t

    def load_tree(self, tree: Tree):
        """Copy a tree in the reference's layout (``"layers"`` stacked;
        tensors, or anything ``torch.as_tensor`` takes) into the model's
        parameters; raises unless every leaf of the declarations is given
        at its shape."""
        with torch.no_grad():
            for mod, name, x in self._slots(tree_map(torch.as_tensor,
                                                     dict(tree))):
                mod._parameters[name].copy_(x)
        return self

    def adopt(self, tree: Tree):
        """Take the tensors of ``tree`` as the parameters, without a copy
        (a model built on ``"meta"`` then holds them): ``tree`` is laid
        out as ``params`` holds them (``"layers"`` and ``"front"`` lists
        of per-layer trees), each tensor at its parameter's shape and
        dtype.  One device only."""
        if self.tp:
            raise NotImplementedError("adopt takes one device's tree")
        for name, param in list(self.params.named_parameters()):
            *path, leaf = name.split(".")
            node, mod = tree, self.params
            for k in path:
                i = int(k) if k.isdigit() else k
                node, mod = node[i], mod[i]
            t = node[leaf]
            if t.shape != param.shape or t.dtype != param.dtype:
                raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, "
                                 f"declared {tuple(param.shape)} "
                                 f"{param.dtype}")
            mod._parameters[leaf] = nn.Parameter(t, requires_grad=False)
        return self

    @contextlib.contextmanager
    def bound(self, tree: Tree):
        """Run the model on ``tree`` (the reference's layout, ``"layers"``
        stacked) in place of its parameters until the block exits: each
        stacked leaf is split into per-layer views (``unbind``, whose
        backward stacks the layers' gradients) and every ``p["wq"]`` reads
        the given tensor, so autograd reaches the tree.  The backward of
        a remat layer recomputes it, so run it inside the block too.  The
        module's own parameters (on ``"meta"`` they hold nothing) are put
        back on exit."""
        saved = []
        try:
            for mod, name, x in self._slots(tree):
                saved.append((mod, name, mod._parameters[name]))
                mod._parameters[name] = x
            yield self
        finally:
            for mod, name, p in reversed(saved):
                mod._parameters[name] = p

    def remat(self, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)``, under ``torch.utils.checkpoint`` (non
        reentrant) when ``cfg.remat`` is set and autograd records: the
        backward recomputes the layer from its input instead of keeping
        its activations, as the reference's ``jax.checkpoint``."""
        if self.cfg.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                fn, *args, use_reentrant=False, **kwargs)
        return fn(*args, **kwargs)

    def abstract(self, dtype: torch.dtype | None = None):
        """The reference's parameter tree as ``meta`` tensors."""
        return abstract(self.decls(), dtype)

    def axes(self):
        return axes_tree(self.decls())

    def n_params(self) -> int:
        return count_params(self.decls())

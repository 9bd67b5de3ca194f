"""CoTM training: coalesced clause pool + signed weights, Type I/II
feedback (the PyTorch port of ``repro.core.train``).

Follows Glimsdal & Granmo (arXiv:2108.07594): per sample, the true class
is reinforced with polarity c=+1 and one uniformly sampled negative class
with polarity c=-1.  For a class update with polarity ``c``:

    v   = clamp(scores[class], -T, T)
    p   = (T - c*v) / (2T)                      # per-clause update probability
    for each clause j drawn with prob p:
        if sign(W[class, j]) == c:  Type I feedback (pattern reinforcement)
        else:                       Type II feedback (pattern invalidation)
        if clause_j fired:          W[class, j] += c

The batch sum of TA deltas factors into three (K, 2B) x (2B, n) count
products once the 1/s thinning field is shared across the batch:

    present = litT   @ (type1 & fired)
    absent  = ~litT  @ (type1 & fired)
    inval   = ~litT  @ (type2 & fired)
    ta_delta = hi*present - lo*(absent + decay) + excluded*inval

The reference runs these products on XLA dots outside any Pallas kernel;
here they are the plain ``kernels.ref.ta_feedback_ref`` (f32 matmuls,
exact for counts below 2**24).

Randomness comes from an explicit ``torch.Generator``.  Every draw can
instead be handed in as an operand (``FeedbackDraws`` and the epoch
permutations), so a test can feed both packages the same numbers: the
reference's ``jax.random.bernoulli(k, p, shape)`` is ``uniform(k, shape)
< p``, and ``FeedbackDraws`` carries those uniforms.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..kernels.ref import ta_feedback_ref
from .cotm import CoTMConfig, CoTMParams, class_scores, clause_outputs, \
    include_mask


@dataclasses.dataclass(frozen=True)
class FeedbackDraws:
    """The random numbers of one feedback sweep over B samples.

    ``neg_offset`` (B,) ints in [1, m): the negative class is ``(label +
    offset) % m``; ``u_sel`` (2B, n) f32 uniforms in [0, 1): a clause row
    is selected where ``u_sel < p``; ``u_lo`` (K, n) f32 uniforms: the 1/s
    penalty draw is ``u_lo < 1/s``; ``u_hi`` (K, n) f32 uniforms, read
    only without ``boost_true_positive``: the reward draw is ``u_hi <
    (s-1)/s``.
    """
    neg_offset: torch.Tensor
    u_sel: torch.Tensor
    u_lo: torch.Tensor
    u_hi: torch.Tensor | None = None

    @staticmethod
    def sample(generator: torch.Generator, batch: int,
               cfg: CoTMConfig) -> "FeedbackDraws":
        """Draw in a fixed order (offset, sel, hi if read, lo) on the
        generator's device."""
        dev = generator.device
        K, n = cfg.n_literals, cfg.n_clauses
        neg = torch.randint(1, cfg.n_classes, (batch,), generator=generator,
                            device=dev)
        u_sel = torch.rand((2 * batch, n), generator=generator, device=dev)
        u_hi = (None if cfg.boost_true_positive
                else torch.rand((K, n), generator=generator, device=dev))
        u_lo = torch.rand((K, n), generator=generator, device=dev)
        return FeedbackDraws(neg_offset=neg, u_sel=u_sel, u_lo=u_lo,
                             u_hi=u_hi)

    def to(self, device) -> "FeedbackDraws":
        return FeedbackDraws(*(None if t is None else torch.as_tensor(
            t, device=device) for t in dataclasses.astuple(self)))


def _below(u: torch.Tensor, p: float) -> torch.Tensor:
    """``u < p`` with ``p`` rounded to f32 first, as the reference's
    ``bernoulli`` converts its probability to the uniforms' dtype."""
    return u.to(torch.float32) < torch.tensor(p, dtype=torch.float32,
                                              device=u.device)


def ta_draws(draws: FeedbackDraws,
             cfg: CoTMConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (hi, lo) (K, n) int32 per-TA draws."""
    s = cfg.specificity
    lo = _below(draws.u_lo, 1.0 / s).to(torch.int32)
    if cfg.boost_true_positive:
        hi = torch.ones_like(lo)
    else:
        if draws.u_hi is None:
            raise ValueError("boost_true_positive=False needs u_hi")
        hi = _below(draws.u_hi, (s - 1.0) / s).to(torch.int32)
    return hi, lo


def feedback_masks(fired: torch.Tensor, scores: torch.Tensor,
                   weights: torch.Tensor, labels: torch.Tensor,
                   draws: FeedbackDraws, cfg: CoTMConfig):
    """The doubled-batch feedback rows: true class (polarity +1), then the
    sampled negative class (polarity -1).

    fired (B, n) bool training-semantics clause outputs; scores (B, m);
    weights (m, n) -> (tgt (2B,), pol (2B,), sel, match, fired2 (2B, n)
    bool).
    """
    B = fired.shape[0]
    m, T = cfg.n_classes, cfg.threshold
    dev = fired.device
    labels = labels.to(device=dev, dtype=torch.int64)
    neg = (labels + draws.neg_offset.to(device=dev,
                                        dtype=torch.int64)) % m
    tgt = torch.cat([labels, neg])
    pol = torch.cat([torch.ones(B, dtype=torch.int32, device=dev),
                     -torch.ones(B, dtype=torch.int32, device=dev)])
    rows = torch.arange(B, device=dev)
    v = torch.clamp(torch.cat([scores[rows, labels], scores[rows, neg]]),
                    -T, T)
    p = (T - pol * v).to(torch.float32) / (2 * T)
    sel = draws.u_sel.to(device=dev, dtype=torch.float32) < p[:, None]
    sign = torch.where(weights[tgt] >= 0, 1, -1)
    match = sign == pol[:, None]
    fired2 = torch.cat([fired, fired])
    return tgt, pol, sel, match, fired2


def weight_deltas(tgt: torch.Tensor, pol: torch.Tensor, sel: torch.Tensor,
                  fired2: torch.Tensor, m: int) -> torch.Tensor:
    """(m, n) int32: each selected fired row adds its polarity to its
    target class's weight (the reference's one-hot product, as an exact
    integer scatter-add)."""
    upd = pol[:, None] * (sel & fired2).to(torch.int32)
    out = torch.zeros((m, upd.shape[1]), dtype=torch.int32,
                      device=upd.device)
    return out.index_add_(0, tgt, upd)


def batch_deltas(params: CoTMParams, literals, labels,
                 generator: torch.Generator | None, cfg: CoTMConfig, *,
                 draws: FeedbackDraws | None = None,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Summed (ta_delta (K, n), w_delta (m, n)) int32 for a batch.  The
    draws come from ``draws`` when given, else from ``generator``."""
    dev = params.ta_state.device
    lit = torch.as_tensor(literals, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    if draws is None:
        if generator is None:
            raise ValueError("batch_deltas needs a generator or draws")
        draws = FeedbackDraws.sample(generator, lit.shape[0], cfg)

    inc = include_mask(params.ta_state, cfg.n_states)
    fired = clause_outputs(lit, inc, training=True)
    scores = class_scores(fired, params.weights)
    tgt, pol, sel, match, fired2 = feedback_masks(
        fired, scores, params.weights, labels, draws, cfg)
    hi, lo = ta_draws(draws.to(dev), cfg)
    lit2 = torch.cat([lit, lit]).to(torch.int8)
    ta_delta = ta_feedback_ref(lit2, fired2, sel, match, hi, lo, inc)
    return ta_delta, weight_deltas(tgt, pol, sel, fired2, cfg.n_classes)


def apply_deltas(params: CoTMParams, ta_delta: torch.Tensor,
                 w_delta: torch.Tensor, cfg: CoTMConfig) -> CoTMParams:
    ta = torch.clamp(params.ta_state + ta_delta, 1, 2 * cfg.n_states)
    return CoTMParams(ta_state=ta.to(torch.int32),
                      weights=(params.weights + w_delta).to(torch.int32))


def train_step_batch(params: CoTMParams, literals, labels,
                     generator: torch.Generator | None, cfg: CoTMConfig, *,
                     draws: FeedbackDraws | None = None) -> CoTMParams:
    ta_d, w_d = batch_deltas(params, literals, labels, generator, cfg,
                             draws=draws)
    return apply_deltas(params, ta_d, w_d, cfg)


def train_step_sequential(params: CoTMParams, literals, labels,
                          generator: torch.Generator | None,
                          cfg: CoTMConfig, *,
                          draws: Sequence[FeedbackDraws] | None = None,
                          ) -> CoTMParams:
    """Faithful per-sample sequential updates: sample ``i`` takes the
    batch-of-one step with ``draws[i]`` (or fresh draws)."""
    dev = params.ta_state.device
    lit = torch.as_tensor(literals, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    for i in range(lit.shape[0]):
        params = train_step_batch(params, lit[i:i + 1], labels[i:i + 1],
                                  generator, cfg,
                                  draws=None if draws is None else draws[i])
    return params


def train_epochs(params: CoTMParams, literals, labels,
                 generator: torch.Generator, cfg: CoTMConfig, *,
                 epochs: int = 1, batch_size: int = 32,
                 sequential: bool = False,
                 perms: Sequence[torch.Tensor] | None = None) -> CoTMParams:
    """Host-side training loop: shuffles once per epoch (``perms[e]`` when
    given, else ``torch.randperm`` on ``generator``) and drops the ragged
    tail batch."""
    dev = params.ta_state.device
    literals = torch.as_tensor(literals, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    n = literals.shape[0]
    n_batches = n // batch_size
    step = train_step_sequential if sequential else train_step_batch
    for e in range(epochs):
        perm = (torch.randperm(n, generator=generator, device=dev)
                if perms is None else torch.as_tensor(perms[e], device=dev))
        lit = literals[perm][:n_batches * batch_size]
        lab = labels[perm][:n_batches * batch_size]
        for b in range(n_batches):
            sl = slice(b * batch_size, (b + 1) * batch_size)
            params = step(params, lit[sl], lab[sl], generator, cfg)
    return params

"""Document classification: an LM's pooled final states read by a CoTM
head on IMPACT's Y-Flash crossbar.

A ``Classifier`` holds a built LM (a ``TransformerLM``: DeepSeek-V2-Lite
at its published settings is ``configs.deepseek_v2_lite_16b.published()``),
the ``TMHead`` that booleanizes its pooled features, and the head's
deployment as a programmed ``IMPACTSystem`` (built elsewhere, e.g. with
``convert.system_from_arrays``), compiled once with
``RuntimeSpec(metering="fused", capacity=B)``.  Nothing is programmed on
the classification path.

``classify(tokens, lengths)`` runs, for B right-padded documents:

1. ``model.hidden`` on the tokens (causal, so the padding never reaches
   a document's valid positions), then the final norm;
2. ``pool_features`` over each document's valid positions, in f32;
3. ``TMHead.booleanize``: ``[bits, ~bits]`` of K = 2 d literals;
4. ``session.infer_step`` with every lane valid.

Spans ``classify.literals`` (steps 2-3) and ``classify.head`` (step 4)
and the counter ``lm.valid_tokens`` record in ``repro_torch.tracing``
while it records (``lm.hidden`` and the layers' own spans inside step
1); the counters the layers summed on the card are read once a batch,
at the end of ``classify``, only then.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import tracing
from ..impact.pipeline import IMPACTSystem
from ..impact.runtime import InferenceResult, RuntimeSpec
from ..models.tm_head import TMHead, pool_features


@dataclasses.dataclass
class Classified:
    """One batch's answer, on the device."""
    result: InferenceResult        # predictions and per-lane energies
    literals: torch.Tensor         # (B, K) int8, what the head read
    features: torch.Tensor         # (B, d) f32 pooled features
    hidden: torch.Tensor | None    # (B, P, d) f32 final states, on request


class Classifier:
    """An LM backbone, a CoTM head and the head's crossbar session, for
    batches of ``capacity`` documents."""

    def __init__(self, model, head: TMHead, system: IMPACTSystem,
                 capacity: int, device: str | torch.device | None = None):
        if head.cotm_cfg.n_literals != system.n_literals:
            raise ValueError(f"the head booleanizes to "
                             f"{head.cotm_cfg.n_literals} literals, the "
                             f"system takes {system.n_literals}")
        self.model, self.head, self.system = model, head, system
        self.capacity = capacity
        dev = torch.device(device) if device is not None else model.device
        self.session = system.compile(RuntimeSpec(
            metering="fused", capacity=capacity, device=str(dev)))
        self.valid = torch.ones(capacity, dtype=torch.bool, device=dev)

    @torch.no_grad()
    def classify(self, tokens: torch.Tensor, lengths: torch.Tensor,
                 positions: torch.Tensor | None = None) -> Classified:
        """tokens (B, S) int right-padded, lengths (B,) int on the device
        -> ``Classified``; with ``positions`` (B, P) int, the final
        states there too."""
        B, S = tokens.shape
        if B != self.capacity:
            raise ValueError(f"a batch of {B} documents; the session "
                             f"serves {self.capacity}")
        pos = torch.arange(S, device=tokens.device).expand(B, S)
        x, _ = self.model.hidden(tokens, pos)
        with tracing.span("classify.literals"):
            x = self.model.normed(x)
            features = pool_features(x.float(), pos < lengths[:, None])
            literals = self.head.booleanize(features).to(torch.int8)
            hidden = None
            if positions is not None:
                idx = positions.long()[..., None].expand(-1, -1, x.shape[-1])
                hidden = torch.gather(x, 1, idx).float()
        with tracing.span("classify.head"):
            result = self.session.infer_step(literals, self.valid)
        if tracing.recording():
            tracing.add_device("lm.valid_tokens", lengths.sum())
            tracing.flush()
        return Classified(result, literals, features, hidden)

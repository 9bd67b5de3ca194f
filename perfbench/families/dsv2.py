"""The DeepSeek-V2 family: DeepSeek-V2-Lite at its published settings as
the backbone of a document classifier whose CoTM head runs on IMPACT's
Y-Flash crossbar, served by the port's ``Classifier``
(``repro_torch.serve.classify``) to bulk labelling of documents.

``deploy`` draws the whole model on the device from the seed, leaf by
leaf in bf16: every matrix N(0, 0.02^2) (the published
``initializer_range``), every norm's gain at its published init of one
(``gamma`` 0 in the port's layout); then the head's crossbar deployment,
drawn by ``families.cotm.deploy`` from the configuration's ``head``.
``pool`` draws the traffic's documents: fixed lengths (the quantiles of
a lognormal), sorted by length and cut into batches right-padded to a
multiple of ``pad_to``, token ids from a Zipf law over the vocabulary
with the rank-to-id map permuted by the seed, and the positions each
document is checked at.  ``Cell`` builds the port's model on ``meta``
from ``published()`` with the configuration's sizes, adopts the drawn
weights, hands the head's conductances to the port
(``convert.system_from_arrays``) and serves one batch at a time as a
labeller does: ``Classifier.classify``, the predictions, energies,
literals, features and checked states to the host, a bill a document in
f64 and the batch's ``EnergyReport``.  ``check`` holds the kept batches
to the plain reference (``references/deepseek_v2.py``) and the head's
readings, on the program's own literals, to ``references/cotm.sweep``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from perfbench.families import cotm
from perfbench.references import cotm as cotm_reference
from perfbench.references import deepseek_v2 as reference
from perfbench.yardstick import lm_work
from repro_torch.configs.deepseek_v2_lite_16b import published
from repro_torch.models.config import MLAConfig, YaRNConfig

#: The numbers ``check`` reads; a cell compares those its limits name.
CHECKS = ("hidden_err", "feature_err", "literal_flip", "pred_gap",
          "clause_bill", "class_bill", "class_stage", "report",
          "report_count")
#: Those of them read once a batch.
BATCH_CHECKS = ("report", "report_count")
#: The host spans of one batch, in order.
SPANS = ("classify", "results", "billing")


def model_config(cfg: dict):
    """The port's ``ModelConfig``: ``published()`` at the sizes and
    settings of the configuration's published keys.  Refuses a
    ``routed_scaling_factor`` other than 1 (the port does not scale the
    routed experts' sum) and, by ``YaRNConfig``, YaRN whose ``mscale``
    differs from ``mscale_all_dim``."""
    if cfg["routed_scaling_factor"] != 1:
        raise ValueError(f"routed_scaling_factor "
                         f"{cfg['routed_scaling_factor']} is not 1: the "
                         f"port does not scale the routed experts")
    base = published()
    y = cfg["rope_scaling"]
    return dataclasses.replace(
        base, n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], vocab=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]),
        rope_scaling=None if y is None else YaRNConfig(
            **{k: v for k, v in y.items() if k != "type"}),
        mla=MLAConfig(kv_lora_rank=cfg["kv_lora_rank"],
                      qk_nope_head_dim=cfg["qk_nope_head_dim"],
                      qk_rope_head_dim=cfg["qk_rope_head_dim"],
                      v_head_dim=cfg["v_head_dim"]),
        moe=dataclasses.replace(
            base.moe, n_experts=cfg["n_routed_experts"],
            top_k=cfg["num_experts_per_tok"],
            d_ff_expert=cfg["moe_intermediate_size"],
            n_shared=cfg["n_shared_experts"],
            first_dense_layers=cfg["first_k_dense_replace"],
            d_ff_dense=cfg["intermediate_size"],
            norm_topk_prob=cfg["norm_topk_prob"]))


def _meta_model(cfg: dict):
    from repro_torch.models import build
    return build(model_config(cfg), device="meta")


@dataclasses.dataclass
class Deployment:
    """The model's weights (the port's tree, bf16 on the device), the
    published settings the reference reads, and the head's crossbar."""
    weights: dict
    arch: reference.Arch
    head: cotm.Deployment


def _put(tree: dict, name: str, t: torch.Tensor) -> None:
    *path, leaf = name.split(".")
    node = tree
    for k, nxt in zip(path, path[1:] + [leaf]):
        if isinstance(node, list):
            k = int(k)
            while len(node) <= k:
                node.append({})
            node = node[k]
        else:
            node = node.setdefault(k, [] if nxt.isdigit() else {})
    node[leaf] = t


def deploy(cfg: dict, gen: torch.Generator) -> Deployment:
    """The deployment of ``cfg`` drawn from ``gen`` on its device."""
    std = cfg["assumed"]["initializer_range"]
    weights: dict = {}
    for name, p in _meta_model(cfg).params.named_parameters():
        t = torch.empty(p.shape, dtype=torch.bfloat16, device=gen.device)
        if name.endswith("gamma") or name.endswith("kv_norm"):
            t.zero_()
        else:
            t.normal_(0.0, std, generator=gen)
        _put(weights, name, t)
    head = cotm.deploy(cfg["assumed"]["head"], gen)
    return Deployment(weights, reference.Arch.from_config(cfg), head)


@dataclasses.dataclass
class Batch:
    """One batch of documents, on the device."""
    tokens: torch.Tensor      # (B, S) int64, right-padded
    lengths: torch.Tensor     # (B,) int64
    positions: torch.Tensor   # (B, P) int64, the states checked
    lens: list                # the valid lengths, on the host


def pool(dep: Deployment, traffic: dict,
         gen: torch.Generator) -> list[Batch]:
    """``traffic["pool_batches"]`` batches of ``traffic["batch"]``
    documents: lengths the quantiles of a lognormal (the same every
    seed), sorted and cut into batches, each padded to its longest
    document rounded up to ``pad_to``; token ids Zipf-distributed over
    the vocabulary, ranks permuted by the seed; ``positions_checked``
    valid positions a document drawn from the seed and its last."""
    dev = gen.device
    V = dep.weights["embed"].shape[0]
    B, P = traffic["batch"], traffic["pool_batches"]
    lens = sorted(lm_work.lognormal_lengths(
        B * P, traffic["length_median"], traffic["length_sigma"],
        traffic["length_min"], traffic["length_max"]))
    rank_p = torch.arange(1, V + 1, dtype=torch.float64, device=dev).pow(
        -traffic["zipf_exponent"])
    ids = torch.randperm(V, generator=gen, device=dev)[torch.multinomial(
        rank_p.float(), sum(lens), replacement=True, generator=gen)]
    out, at, pad = [], 0, traffic["pad_to"]
    for b in range(P):
        mine = lens[b * B:(b + 1) * B]
        S = -(-max(mine) // pad) * pad
        tokens = torch.zeros((B, S), dtype=torch.int64, device=dev)
        pos = []
        for j, n in enumerate(mine):
            tokens[j, :n] = ids[at:at + n]
            at += n
            pick = torch.randperm(n, generator=gen, device=dev)[
                :traffic["positions_checked"]].sort().values
            pos.append(torch.cat([pick, torch.tensor([n - 1], device=dev)]))
        out.append(Batch(tokens, torch.tensor(mine, device=dev),
                         torch.stack(pos), mine))
    return out


@dataclasses.dataclass
class Output:
    """What one batch hands its user, on the host (the head's fields as
    ``families.cotm.Output``'s)."""
    predictions: np.ndarray   # (B,) int
    e_clause: np.ndarray      # (B,) J
    e_class: np.ndarray       # (B,) J
    bills: np.ndarray         # (B,) f64 J, a bill a document
    read_energy_j: float      # the batch report's read energy
    datapoints: int           # the batch report's datapoints
    literals: np.ndarray      # (B, K) int8, what the head read
    features: np.ndarray      # (B, d) f32 pooled features
    hidden: np.ndarray        # (B, P, d) f32 final states at the positions


class Cell:
    """One deployment, its pool and the port's classifier serving it."""

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.device = device
        gen = torch.Generator(device=device).manual_seed(seed)
        self.dep = deploy(cfg, gen)
        self.pool = pool(self.dep, traffic, gen)
        self.batch_size = B = traffic["batch"]
        K = self.dep.head.n_literals
        # Each batch's work, for ``metrics/lm_mfu.py`` and
        # ``lm_roofline.py`` (``lm_work.served``).
        lm_work.record_pool(lm_work.batch_work(cfg, b.lens, K)
                            for b in self.pool)
        flops, least_s = lm_work.served(len(self.pool))
        self.flops_per_datapoint = flops / (B * len(self.pool))
        #: The mean over the pool's batches of a batch's least time.
        self.sweep_bound_s = least_s / len(self.pool)

        from repro_torch.convert import system_from_arrays
        from repro_torch.impact.yflash import read_current
        from repro_torch.models import TMHead, TMHeadConfig
        from repro_torch.serve import Classifier
        h = self.dep.head
        hc = cfg["assumed"]["head"]
        host = lambda t: t.cpu().numpy()
        system = system_from_arrays(dict(
            clause_g=host(h.clause_g), nonempty=host(h.nonempty),
            class_g=host(h.class_g),
            clause_i=host(read_current(h.clause_g)),
            class_i=host(read_current(h.class_g)),
            n_literals=K, n_clauses=h.n_clauses, n_classes=h.n_classes,
            # Programmed outside the port: no programming energy to bill.
            program_energy_j=0.0, erase_energy_j=0.0,
            cfg=dict(max_tile_rows=hc["max_tile_rows"],
                     max_tile_cols=hc["max_tile_cols"],
                     max_class_rows=hc["max_class_rows"]),
        ), device=device)
        head = TMHead(TMHeadConfig(
            n_classes=h.n_classes, n_clauses=h.n_clauses,
            bits_per_feature=hc["bits_per_feature"]),
            d_features=cfg["hidden_size"])
        model = _meta_model(cfg).adopt(self.dep.weights)
        self.classifier = Classifier(model, head, system, capacity=B,
                                     device=device)

    def batch(self, i: int, spans: dict, label=None) -> tuple[Output, float]:
        """Serve pool batch ``i`` -> (its output on the host, seconds from
        issuing it to holding its bills and report).  Adds each span's
        seconds to ``spans``; ``label(name)`` marks it for a profiler."""
        label = label or (lambda name: contextlib.nullcontext())
        b = self.pool[i]
        t0 = time.perf_counter()
        with label(SPANS[0]):
            c = self.classifier.classify(b.tokens, b.lengths, b.positions)
        t1 = time.perf_counter()
        with label(SPANS[1]):
            pred = c.result.predictions.cpu().numpy()
            e_cl = c.result.e_clause_lanes.cpu().numpy()
            e_cs = c.result.e_class_lanes.cpu().numpy()
            lits = c.literals.cpu().numpy()
            feats = c.features.cpu().numpy()
            hidden = c.hidden.cpu().numpy()
        t2 = time.perf_counter()
        with label(SPANS[2]):
            bills = e_cl.astype(np.float64) + e_cs.astype(np.float64)
            report = self.classifier.system.step_report(e_cl, e_cs,
                                                        len(pred))
        t3 = time.perf_counter()
        for name, dt in zip(SPANS, (t1 - t0, t2 - t1, t3 - t2)):
            spans[name] = spans.get(name, 0.0) + dt
        return Output(pred, e_cl, e_cs, bills, report.read_energy_j,
                      report.datapoints, lits, feats, hidden), t3 - t0

    def launches(self) -> int:
        """The port's own kernel launches so far (graph replays
        included)."""
        from repro_torch.kernels._build import launch_counts
        return sum(launch_counts().values())

    def close(self) -> None:
        """Free the program's state: the classifier, its model's hold on
        the weights, the session and its graphs."""
        self.classifier = None


def _answers(dep: Deployment, pool_: list[Batch], batches,
             precision: str = "float32") -> dict:
    """The reference's ``Answer`` of each pool batch in ``batches``, in
    one pass over the layers."""
    batches = sorted(set(batches))
    docs, pos = [], []
    for i in batches:
        b = pool_[i]
        for j, n in enumerate(b.lens):
            docs.append(b.tokens[j, :n])
            pos.append(b.positions[j])
    a = reference.forward(dep.weights, docs, pos, dep.arch,
                          precision=precision)
    out, at = {}, 0
    for i in batches:
        B = len(pool_[i].lens)
        out[i] = reference.Answer(a.hidden[at:at + B],
                                  a.features[at:at + B],
                                  a.literals[at:at + B])
        at += B
    return out


def _rel(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Relative L2 error over the last axis."""
    return ((got - want).norm(dim=-1)
            / want.norm(dim=-1).clamp(min=1e-30))


def readings(out: Output, want: reference.Answer, dep: Deployment) -> dict:
    """The numbers of one batch, each the worst over its documents, and
    the per-document numbers (for counting failures).

    ``hidden_err``: the worst, over a document's checked positions, of
    the final state's relative L2 error.  ``feature_err``: the pooled
    features' relative L2 error.  ``literal_flip``: the share of the
    document's literals that differ from the reference's.  The head's
    numbers (``families.cotm.readings``) hold the program's predictions
    and bills to ``references/cotm.sweep`` on the program's own
    literals."""
    hid = torch.from_numpy(out.hidden).double()
    ref_h = torch.stack(want.hidden).double().cpu()
    hidden_err = _rel(hid, ref_h).amax(dim=1)
    feature_err = _rel(torch.from_numpy(out.features).double(),
                       want.features.double().cpu())
    flip = (torch.from_numpy(out.literals).long()
            != want.literals.long().cpu()).double().mean(dim=1)
    h = dep.head
    sweep = cotm_reference.sweep(
        torch.from_numpy(out.literals).to(h.clause_g.device), h.clause_g,
        h.nonempty, h.class_g)
    r = cotm.readings(out, sweep)
    each = dict(r["per_datapoint"], hidden_err=hidden_err,
                feature_err=feature_err, literal_flip=flip)
    return dict(r, per_datapoint=each,
                **{k: float(v.max()) for k, v in each.items()})


def control_output(batch: Batch, dep: Deployment) -> Output:
    """The control in the program's place: the reference's forward with
    every product's operands rounded to 3 mantissa bits (e4m3's), and
    its head as ``families.cotm.control_output`` sweeps it, handed over
    as the program hands its results."""
    i = 0
    a = _answers(dep, [batch], [i], precision="e4m3")[i]
    head = cotm.control_output(a.literals, dep.head)
    return Output(head.predictions, head.e_clause, head.e_class, head.bills,
                  head.read_energy_j, head.datapoints,
                  a.literals.cpu().numpy(),
                  a.features.float().cpu().numpy(),
                  torch.stack(a.hidden).float().cpu().numpy())


def check(dep: Deployment, pool_: list[Batch],
          kept: list[tuple[int, Output]], limits: dict) -> tuple[dict, int]:
    """Hold every kept ``(pool index, output)`` to the reference ->
    ({name: worst reading} of every number in ``CHECKS``, documents that
    broke the limit of a number the cell compares; a batch whose report
    breaks its limit fails every document)."""
    want = _answers(dep, pool_, [i for i, _ in kept])
    worst = dict.fromkeys(CHECKS, 0.0)
    failed = 0
    for i, out in kept:
        r = readings(out, want[i], dep)
        for name in CHECKS:
            if not r[name] <= worst[name]:      # a NaN reading stays NaN
                worst[name] = r[name]
        bad = torch.zeros_like(r["per_datapoint"]["hidden_err"],
                               dtype=torch.bool)
        for name, v in r["per_datapoint"].items():
            if name in limits:
                bad |= ~(v <= limits[name])
        if any(not r[n] <= limits[n] for n in BATCH_CHECKS if n in limits):
            bad[:] = True
        failed += int(bad.sum())
    return worst, failed

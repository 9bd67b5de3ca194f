"""Serving driver: batched requests through prefill + decode on the port's
LM ``Engine`` (the port of ``examples/serve_lm.py``).

Builds a reduced model of one of the ten architectures (about 100M
parameters, random weights from a seed), enqueues ragged requests through
the batching queue, and streams greedy or temperature generations.

Run (on the card, or ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.serve_lm --arch qwen3-8b
    PYTHONPATH=src python -m repro_torch.serve_lm --arch rwkv6-7b \\
        --tokens 64 [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .configs import ARCH_IDS, get_config
from .device import resolve_device
from .models import build
from .serve import BatchingQueue, Engine, Request, ServeConfig


def hundred_m_variant(cfg):
    """Shrink an assigned config toward ~100M params, same family (the
    reference's ``examples/train_lm.py`` recipe)."""
    changes = dict(n_layers=min(cfg.n_layers, 8), d_model=512,
                   n_heads=8, n_kv_heads=min(cfg.n_kv_heads, 4),
                   head_dim=64, d_ff=1536, vocab=min(cfg.vocab, 32768),
                   attn_chunk_q=128, attn_chunk_k=256, remat=False)
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 8), top_k=2,
            d_ff_expert=768,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
            d_ff_dense=1536 if cfg.moe.d_ff_dense else None)
    if cfg.mla is not None:
        changes["mla"] = dataclasses.replace(cfg.mla, kv_lora_rank=128,
                                             qk_nope_head_dim=32,
                                             qk_rope_head_dim=16,
                                             v_head_dim=32)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, chunk=32)
        changes["n_layers"] = min(cfg.n_layers, 12)
    if cfg.hybrid_attn_every:
        changes["hybrid_attn_every"] = 4
    return dataclasses.replace(cfg, **changes)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=ARCH_IDS)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = hundred_m_variant(get_config(args.arch))
    model = build(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(0))
    print(f"{args.arch} (reduced): {model.n_params() / 1e6:.1f}M params "
          f"on {dev}")

    engine = Engine(model, ServeConfig(max_len=256,
                                       temperature=args.temperature))

    # Ragged requests arrive; the queue batches and pads them.
    rng = np.random.default_rng(0)
    queue = BatchingQueue(max_batch=4, max_wait_s=0.01)
    for rid in range(args.requests):
        plen = int(rng.integers(8, 24))
        queue.add(Request(rid, rng.integers(
            0, cfg.vocab, plen).astype(np.int32), args.tokens))

    served = 0
    while queue.pending:
        time.sleep(0.02)
        if not queue.ready():
            continue
        batch = queue.take()
        toks, _ = BatchingQueue.pad(batch)
        gen, stats = engine.generate(toks, args.tokens, seed=served)
        served += len(batch)
        print(f"batch of {len(batch)}: prefill {stats['prefill_s']:.2f}s, "
              f"decode {stats['decode_tok_per_s']:.1f} tok/s")
        for r, row in zip(batch, gen.cpu().numpy()):
            print(f"  req {r.rid}: prompt[{len(r.tokens)}] -> "
                  f"{row.flatten()[:8].tolist()}...")
    print(f"served {served} requests")
    return served


if __name__ == "__main__":
    main()

"""End-to-end LM training driver, the port of ``examples/train_lm.py``: a
~100M-parameter variant of one of the ten architectures takes AdamW
steps with gradient accumulation in the fault-tolerant ``TrainLoop``
(auto-resume, heartbeat, async checkpoints) on the synthetic Markov
token stream, and the loss must fall.

    python3 -m repro_torch.train_lm --steps 200          # on the card
    python3 -m repro_torch.train_lm --arch rwkv6-7b --steps 50
    python3 -m repro_torch.train_lm --device cpu --steps 20 --batch 2 \\
        --seq 64

The weights are drawn from a seeded generator on the device.  Two
differences from the reference's example: after a resume the data stream
starts at the resumed step (the reference's restarts at its first
batch), so a resumed run sees the batches an uninterrupted one does and
ends on the same losses; and qwen2-vl trains (the reference's example
refuses it: its variant keeps M-RoPE sections for a head of 128 and its
batches carry no positions): the variant splits its head of 64 in the
same proportions, and its batches carry M-RoPE positions (text only,
the three streams equal).  ``--accum`` splits each batch into that many
microbatches (the reference parses it and feeds one).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from .configs import ARCH_IDS, get_config
from .device import resolve_device
from .launch.specs import synth_tokens
from .models import build
from .train import (AdamWConfig, CheckpointManager, RuntimeConfig,
                    TrainLoop, init_state, make_train_step)


def hundred_m_variant(cfg):
    """Shrink an assigned config toward ~100M params, same family."""
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
    if cfg.rope_style == "mrope":
        # the sections split head_dim / 2 = 32 frequencies, as the full
        # config's split its 64 (the reference's variant keeps (16, 24,
        # 24), which no head of 64 can take)
        half = changes["head_dim"] // 2
        total = sum(cfg.mrope_sections)
        changes["mrope_sections"] = tuple(s * half // total
                                          for s in cfg.mrope_sections)
    return dataclasses.replace(cfg, **changes)


def lm_batch(cfg, tokens: np.ndarray, accum: int) -> dict:
    """Tokens (B, S[, C]) -> a train step's batch: tokens (accum, B /
    accum, S[, C]), and for M-RoPE text-only positions (accum, 3, B /
    accum, S), the three streams counting the tokens."""
    B, S = tokens.shape[:2]
    if B % accum:
        raise ValueError(f"batch {B} is not a multiple of accum {accum}")
    out = {"tokens": tokens.reshape((accum, B // accum) + tokens.shape[1:])}
    if cfg.rope_style == "mrope":
        out["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(S, dtype=np.int32), (accum, 3, B // accum, S)))
    return out


def train(arch: str = "llama3-8b", *, steps: int = 200, batch: int = 8,
          seq: int = 256, accum: int = 1, lr: float = 3e-4,
          ckpt_dir: str = "repro_train_lm", save_every: int = 50,
          fail_at_step: int | None = None,
          device: str | torch.device | None = None, log=print) -> dict:
    """One run of the driver; -> {"losses", "start", "loop", "model"}.
    Resumes from the newest checkpoint in ``ckpt_dir``; ``fail_at_step``
    raises ``SimulatedFailure`` there (the test hook)."""
    dev = resolve_device(device)
    cfg = hundred_m_variant(get_config(arch))
    model = build(cfg, device=dev)
    log(f"{arch} (reduced): {model.n_params() / 1e6:.1f}M params on {dev}")

    opt_cfg = AdamWConfig(lr=lr, warmup_steps=20)
    gen = torch.Generator(dev).manual_seed(0)
    state = init_state(model.init(gen).tree(), opt_cfg)
    step = make_train_step(model, opt_cfg, device=dev)

    tokens = synth_tokens(cfg, batch * 16, seq)

    def data(i):
        while True:
            lo = (i * batch) % (tokens.shape[0] - batch)
            yield lm_batch(cfg, tokens[lo:lo + batch], accum)
            i += 1

    start = CheckpointManager(ckpt_dir).latest_step() or 0
    loop = TrainLoop(step, state, data(start),
                     RuntimeConfig(ckpt_dir=ckpt_dir, max_steps=steps,
                                   save_every=save_every,
                                   fail_at_step=fail_at_step),
                     device=dev)
    if start:
        log(f"auto-resumed from step {start}")
    try:
        loop.run(seed=0)
    finally:
        loop.mgr.wait()      # an async write in flight ends before we do
    return dict(losses=[m["loss"] for m in loop.metrics_log], start=start,
                loop=loop, model=model)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3-8b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="repro_train_lm")
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu only when asked")
    args = ap.parse_args(argv)

    out = train(args.arch, steps=args.steps, batch=args.batch,
                seq=args.seq, accum=args.accum, lr=args.lr,
                ckpt_dir=args.ckpt_dir, device=args.device)
    losses = out["losses"]
    if losses:
        k = max(len(losses) // 10, 1)
        print(f"loss: first10={np.mean(losses[:k]):.3f} "
              f"last10={np.mean(losses[-k:]):.3f} "
              f"steps={len(losses)} "
              f"stragglers={out['loop'].straggler_events}")
        if not np.mean(losses[-k:]) < np.mean(losses[:k]):
            raise SystemExit("loss did not decrease")
        print("OK: loss decreased")


if __name__ == "__main__":
    main()

"""Plain PyTorch reference of one metered sweep of an IMPACT crossbar
deployment: what a CoTM served on Y-Flash tiles must answer for each
datapoint, worked out from the conductances.

It imports torch and the benchmark's frozen Y-Flash read model, nothing
of the program.  It takes the deployment's conductances and the literals
(the benchmark's own inputs) and works out again what the program
derives from them: each cell's read current, each column's current over
the driven rows (a literal 0 drives its row at V_R), the CSA decision of
every clause (all row shards below 4.1 uA, and the clause nonempty), the
class currents of the fired clauses, the prediction (their argmax) and
the read energy each datapoint draws from the clause and class tiles
(V_R * I * t_read summed over every physical column).

``precision="float64"`` is the reference.  ``precision="tf32"`` is the
correctness control: the same sweep in the precision just below the
configuration's IEEE f32 with TF32 off, namely f32 products of operands
rounded to TF32.  On a card that is the card's own TF32 matrix product;
on the CPU, which has none, the currents are rounded to TF32 (10
mantissa bits, to nearest even) before f32 products.
"""
from __future__ import annotations

import contextlib

import torch

from perfbench.yardstick.yflash import I_CSA_THRESHOLD, T_READ, V_READ, read_current

PRECISIONS = ("float64", "tf32")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(precision: str, device: torch.device):
    """f64 products as they are; TF32 products on a card for ``"tf32"``,
    with the process's setting restored after."""
    if precision != "tf32" or device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def sweep(literals: torch.Tensor, clause_g: torch.Tensor,
          nonempty: torch.Tensor, class_g: torch.Tensor, *,
          precision: str = "float64", block: int = 4096,
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """literals (B, K) {0, 1}; clause_g (R, C, tr, tc) and class_g (S, sr,
    m) conductances (S); nonempty (C*tc,) -> (class currents (B, m) in A,
    clause read energy (B,) in J, class read energy (B,) in J), in f64
    for the reference and f32 for the control, computed ``block`` rows
    at a time."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    dev = clause_g.device
    dt = torch.float64 if precision == "float64" else torch.float32
    R, C, tr, tc = clause_g.shape
    S, sr, m = class_g.shape
    B, K = literals.shape
    # Each row shard's (tr, C*tc) cells, and each class shard's (sr, m).
    cl = read_current(clause_g.to(dt)).permute(0, 2, 1, 3).reshape(
        R, tr, C * tc)
    cs = read_current(class_g.to(dt))
    if precision == "tf32" and dev.type != "cuda":
        cl, cs = to_tf32(cl), to_tf32(cs)
    ne = nonempty.to(dev, torch.bool)
    n_drive = min(C * tc, S * sr)
    scores, e_cl, e_cs = [], [], []
    with _matmul_precision(precision, dev):
        for b0 in range(0, B, block):
            lit = literals[b0:b0 + block].to(dev)
            nb = lit.shape[0]
            drive = torch.zeros((nb, R * tr), dtype=dt, device=dev)
            drive[:, :K] = 1 - lit.to(dt)
            i_col = torch.stack([drive[:, r * tr:(r + 1) * tr] @ cl[r]
                                 for r in range(R)], dim=1)  # (nb, R, C*tc)
            fired = (i_col < I_CSA_THRESHOLD).all(dim=1) & ne
            drive_c = torch.zeros((nb, S * sr), dtype=dt, device=dev)
            drive_c[:, :n_drive] = fired[:, :n_drive].to(dt)
            i_cls = torch.stack([drive_c[:, s * sr:(s + 1) * sr] @ cs[s]
                                 for s in range(S)], dim=1)  # (nb, S, m)
            scores.append(i_cls.sum(dim=1))
            e_cl.append(V_READ * i_col.sum(dim=(1, 2)) * T_READ)
            e_cs.append(V_READ * i_cls.sum(dim=(1, 2)) * T_READ)
    return torch.cat(scores), torch.cat(e_cl), torch.cat(e_cs)


def datapoint(literals: torch.Tensor, clause_g: torch.Tensor,
              nonempty: torch.Tensor, class_g: torch.Tensor,
              ) -> tuple[torch.Tensor, float, float]:
    """One datapoint (K,) by loops over the physical cells, in f64: the
    sweep's definition, which ``sweep`` holds to in the tests."""
    R, C, tr, tc = clause_g.shape
    S, sr, m = class_g.shape
    K = literals.shape[0]
    e_cl = 0.0
    fired = []
    for c in range(C):
        for j in range(tc):
            below = True
            for r in range(R):
                i = 0.0
                for k in range(tr):
                    row = r * tr + k
                    if row < K and int(literals[row]) == 0:
                        i += float(read_current(clause_g[r, c, k, j].double()))
                e_cl += V_READ * i * T_READ
                below = below and i < I_CSA_THRESHOLD
            fired.append(below and bool(nonempty[c * tc + j]))
    scores = torch.zeros(m, dtype=torch.float64)
    e_cs = 0.0
    for s in range(S):
        for k in range(sr):
            row = s * sr + k
            if row < len(fired) and fired[row]:
                i = read_current(class_g[s, k].double())
                scores += i
                e_cs += V_READ * float(i.sum()) * T_READ
    return scores, e_cl, e_cs

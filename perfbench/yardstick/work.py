"""The work of a metered crossbar sweep from its shapes and its inputs,
and the H100's published peaks, frozen.

The peaks and ``bound_s`` are copied from
``src/repro_torch/kernels/work.py`` at commit 9445001.  The count itself
is the benchmark's own: it counts what the inputs need, from the
configuration's shapes, the benchmark's include mask and the rows its
literals drive, never from the port's launch plans or tile padding.
Each count returns ``(flops, bytes)``: the operations the sweep must do
and the bytes it must move, each input byte read once and each output
byte written once.
"""
from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet):
# f32 outside the tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

F32 = 4


def bound_s(bytes_moved: float, ops: float,
            peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over ``peak`` -> (seconds,
    ``"bytes"`` or ``"operations"``)."""
    t_b = bytes_moved / PEAK_HBM_BYTES
    t_o = ops / peak
    return (t_o, "operations") if t_o >= t_b else (t_b, "bytes")


def metered_sweep(B: int, K: int, driven: int, n_nonempty: int,
                  n_classes: int) -> tuple[float, float]:
    """One metered sweep of B datapoints on (B, K) int8 literals, each
    datapoint driving ``driven`` of its K rows (a literal 0 drives its
    row; ``[bits, ~bits]`` drives K/2).

    Operations: a multiply and an add at each driven cell of the
    nonempty clause columns (only they can fire), the clause meter as one
    multiply-add a driven row (each row's current summed over every
    column that draws, padding included, is fixed by the deployment), and
    a multiply-add at each cell of the class rows of the nonempty clauses
    (which of them fire is known only after the clause stage).  Bytes:
    the literals, the cells of the nonempty columns over every row (each
    row is driven by some datapoint of a batch), a row sum a row, the
    class rows, and a prediction and two f32 meters a datapoint out."""
    flops = (2.0 * B * driven * (n_nonempty + 1)
             + 2.0 * B * n_nonempty * n_classes)
    moved = (B * K + (K * n_nonempty + K + n_nonempty * n_classes) * F32
             + 3 * B * F32)
    return flops, float(moved)

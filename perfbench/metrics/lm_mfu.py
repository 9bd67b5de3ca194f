"""lm_mfu: the published forward's work for the documents the window
served (``yardstick.lm_work``: the valid tokens' projections and causal
attention), over the window's seconds times the H100's dense bf16 peak
(989 TFLOP/s: the configuration states bf16 weights and activations), in
percent.  The window serves the pool from its first batch on, so the
work is that of the batches it served, each its own
(``lm_work.served``).  The whole step's share of the peak.  None where
no LM cell recorded its pool."""
from perfbench.yardstick import lm_work


def read(run):
    w = lm_work.served(run.batches)
    if w is None:
        return None
    return 100.0 * w[0] / (run.window_s * lm_work.PEAK_BF16_FLOPS)

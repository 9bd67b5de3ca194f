"""lm_roofline: the least time an H100 needs for the traced batches'
work, each batch the larger of its operations over 989 TFLOP/s and its
bytes over 3.35 TB/s (``yardstick.lm_work``: the published forward for
the valid tokens, the weights a batch reads), over the device time of
every kernel the profiled window ran, in percent.  The profiled window
serves the pool from its first batch on, so each traced batch counts its
own bound (``lm_work.served``).  None without a trace, a kernel in it,
or an LM cell's pool."""
from perfbench.yardstick import lm_work


def read(run):
    t = run.trace
    if t is None or t.kernel_s <= 0:
        return None
    w = lm_work.served(t.batches)
    return None if w is None else 100.0 * w[1] / t.kernel_s

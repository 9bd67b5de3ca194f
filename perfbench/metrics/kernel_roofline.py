"""kernel_roofline: the least time an H100 needs for the traced batches'
crossbar work, the larger of FLOPs over 67 TFLOP/s and bytes over 3.35
TB/s (``yardstick.work.metered_sweep``: what the inputs need, the
driven rows over the nonempty columns, the meter by row sums), over the
device time of every kernel the profiled window ran, in percent.  It
counts the same work whatever kernels do it.  None without a trace or a
kernel in it."""


def read(run):
    t = run.trace
    if t is None or t.kernel_s <= 0:
        return None
    return 100.0 * t.batches * run.sweep_bound_s / t.kernel_s

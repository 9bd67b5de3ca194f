"""device_idle_share: the share of the profiled window in which no kernel,
copy or fill ran on the card (``torch.profiler``), in percent."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

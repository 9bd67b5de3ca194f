"""datapoints_per_s: every datapoint classified and billed in the window,
over the window's seconds (host clock)."""


def read(run):
    return run.datapoints / run.window_s

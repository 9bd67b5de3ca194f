"""batch_ms_p95: the 95th percentile, over every batch of the window, of
the time from issuing a batch to holding its predictions, bills and
report on the host (host clock)."""
import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.batch_s) * 1e3, 95))

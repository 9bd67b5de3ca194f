"""launches_per_batch: the port's kernel launches over the window
(``repro_torch.kernels._build.launch_counts()``, which adds a graph's
captured launches at each replay), per batch."""


def read(run):
    return run.launches / run.batches

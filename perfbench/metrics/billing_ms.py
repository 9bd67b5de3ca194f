"""billing_ms: host time over the window from the results on the host to
the bills and the batch's ``EnergyReport`` in hand, per batch (the
benchmark's span around ``IMPACTSystem.step_report`` and the bills)."""


def read(run):
    return 1e3 * run.spans["billing"] / run.batches

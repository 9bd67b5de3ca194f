"""step_report_ms: host time a call of ``IMPACTSystem.step_report``, which
folds a batch's per-lane energies into its ``EnergyReport``: the
program's span ``pipeline.step_report`` (``repro_torch.tracing``) over
its calls, in the profiled window of a ``--trace 1`` run.  The rest of
``billing_ms`` is the caller's f64 bills.  None where the program has no
such span."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    span = tracing.totals().get("pipeline.step_report")
    if not span or not span["count"]:
        return None
    return 1e3 * span["seconds"] / span["count"]

"""copy_in_ms: host time a batch spent copying its operands into the
graph's static inputs (``GraphedEntry.copy_in``, with the wait for the
staging buffer): the program's span ``graphs.copy_in``
(``repro_torch.tracing``) over the calls of ``graphs.replay``, one a
batch of a graphed session whichever entry serves it, in the profiled
window of a ``--trace 1`` run.  None where the program has no such
span."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    t = tracing.totals()
    calls, span = t.get("graphs.replay"), t.get("graphs.copy_in")
    if not calls or not calls["count"] or not span:
        return None
    return 1e3 * span["seconds"] / calls["count"]

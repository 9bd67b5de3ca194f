"""graph_mb_per_batch: megabytes (1e6 B) a batch copied into the graph's
static inputs and cloned out of its static outputs: the program's
counters ``graphs.copy_in_bytes`` and ``graphs.clone_bytes``
(``repro_torch.tracing``) over the calls of ``graphs.replay``, one a
batch of a graphed session whichever entry serves it, in the profiled
window of a ``--trace 1`` run.  None where the program has no such
counter."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    t = tracing.totals()
    calls = t.get("graphs.replay")
    moved = [t.get(n) for n in ("graphs.copy_in_bytes", "graphs.clone_bytes")]
    if not calls or not calls["count"] or not all(moved):
        return None
    return sum(m["count"] for m in moved) / 1e6 / calls["count"]

"""replay_ms: host time a batch spent replaying its CUDA graph
(``GraphedEntry.replay``: the launch, and the launch counts): the
program's span ``graphs.replay`` (``repro_torch.tracing``) over its
calls, one a batch of a graphed session whichever entry serves it, in
the profiled window of a ``--trace 1`` run.  None where the program has
no such span."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    span = tracing.totals().get("graphs.replay")
    if not span or not span["count"]:
        return None
    return 1e3 * span["seconds"] / span["count"]

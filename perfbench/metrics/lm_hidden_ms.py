"""lm_hidden_ms: host time a call of the backbone's forward
(``TransformerLM.hidden``: the embedding and every layer, issued from the
host; the device may still run it after the call returns): the
program's span ``lm.hidden`` (``repro_torch.tracing``) over its calls, in
the profiled window of a ``--trace 1`` run.  None where the program has
no such span."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    span = tracing.totals().get("lm.hidden")
    if not span or not span["count"]:
        return None
    return 1e3 * span["seconds"] / span["count"]

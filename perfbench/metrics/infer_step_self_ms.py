"""infer_step_self_ms: host time a batch inside
``InferenceSession.infer_step`` outside the spans it encloses (the
operand checks, ``input_specs`` and the dispatch to the graph): the
``self_seconds`` of the program's span ``runtime.infer_step``
(``repro_torch.tracing``) over its calls, in the profiled window of a
``--trace 1`` run.  None where the program has no such span."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    step = tracing.totals().get("runtime.infer_step")
    if not step or not step["count"]:
        return None
    return 1e3 * step["self_seconds"] / step["count"]

"""session_call_ms: host time inside ``InferenceSession.infer_step`` over
the window, per batch (the benchmark's span around the call)."""


def read(run):
    return 1e3 * run.spans["session.infer_step"] / run.batches

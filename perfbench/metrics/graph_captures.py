"""graph_captures: CUDA graphs the program captured in the run, all at
set-up (the session's prepared entries, and each capture again after
``refresh_operands``): the program's counter ``graphs.captures``
(``repro_torch.tracing``), which counts with the table off.  None where
the program has no such counter."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    captures = tracing.totals().get("graphs.captures")
    if not captures:
        return None
    return float(captures["count"])

"""expert_skew: the heaviest expert's routed (token, expert) pairs summed
over the MoE layers' calls, over the mean pairs an expert summed the
same way: the program's counters ``moe.max_slots`` and
``moe.mean_slots`` (``repro_torch.tracing``) in the profiled window of a
``--trace 1`` run.  1 is an even load.  None where the program has no
such counter."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    t = tracing.totals()
    top, mean = t.get("moe.max_slots"), t.get("moe.mean_slots")
    if not top or not mean or not mean["count"]:
        return None
    return float(top["count"]) / float(mean["count"])

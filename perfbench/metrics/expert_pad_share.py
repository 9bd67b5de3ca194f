"""expert_pad_share: rows the expert GEMMs computed beyond the routed
(token, expert) pairs, over the pairs, in percent: the program's
counters ``moe.rows`` and ``moe.slots`` (``repro_torch.tracing``) in the
profiled window of a ``--trace 1`` run (0 when every computed row is a
routed pair; a capacity factor of 1.25 pads 25% and more).  None where
the program has no such counter."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    t = tracing.totals()
    rows, slots = t.get("moe.rows"), t.get("moe.slots")
    if not rows or not slots or not slots["count"]:
        return None
    return 100.0 * (rows["count"] - slots["count"]) / slots["count"]

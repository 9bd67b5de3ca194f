"""The port's LM configs against the reference's, field for field.

The port's ``ModelConfig`` / ``MoEConfig`` carry fields the reference
lacks (``rope_scaling``; ``norm_topk_prob``, ``router_f32``), for the published models' own settings.  A registry
config must hold each at the default that reproduces the reference's
mathematics; ``reference_fields`` checks that and returns the rest of
``dataclasses.asdict``, which must equal the reference's.
"""
import dataclasses

#: The port's fields the reference lacks, each with the default that
#: reproduces the reference's mathematics.
NEW_FIELDS = {"rope_scaling": None}
NEW_MOE_FIELDS = {"norm_topk_prob": True, "router_f32": False}


def reference_fields(cfg) -> dict:
    """``dataclasses.asdict(cfg)`` without the port's new fields, after
    asserting that each holds its reference default."""
    d = dataclasses.asdict(cfg)
    for k, v in NEW_FIELDS.items():
        assert d.pop(k) == v, (cfg.name, k)
    if d["moe"] is not None:
        for k, v in NEW_MOE_FIELDS.items():
            assert d["moe"].pop(k) == v, (cfg.name, k)
        assert d["moe"]["capacity_factor"] is not None, cfg.name
    return d

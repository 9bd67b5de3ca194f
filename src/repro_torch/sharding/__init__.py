"""Distribution: the logical-axis rule tables (``rules.py``) and the
``torch.distributed`` lowering of the IMPACT crossbar grid
(``crossbar.py``).

``crossbar`` is not imported here, as in the reference: it imports
``kernels.ops``, which imports it back lazily.  Import it explicitly:
``from repro_torch.sharding import crossbar``.
"""
from .rules import (act_rules, crossbar_rules, merged_rules, opt_rules,
                    param_rules)

__all__ = ["param_rules", "opt_rules", "act_rules", "merged_rules",
           "crossbar_rules"]

"""Static analysis of the port: prove the datapath's invariants before
it runs.

* ``analysis.lint`` (stdlib ``ast`` only): the repository's contract
  rules ``IMPACT001``-``005`` over ``src/repro_torch``, with per-line
  waivers (``# lint: waive IMPACTnnn -- reason``);
* ``analysis.smem``: the Hopper working set (shared memory, registers) of
  each kernel a session launches, and the blocks an SM the compiled
  kernels allow against their planners' assumptions;
* ``analysis.ir_audit``: ``InferenceSession.audit()``, over the session's
  op traces (precision ladder, host isolation, fingerprints), the working
  sets and, on a card, the compiled kernels' SASS.
"""
from . import ir_audit, lint, smem

__all__ = ["ir_audit", "lint", "smem"]

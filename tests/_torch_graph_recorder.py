"""A stand-in for ``repro_torch.impact.graphs.capture`` on the CPU, which
cannot capture a CUDA graph: the recorder runs an entry's body (or a
stage's) on the static buffers at capture and again at every replay,
and logs both.  ``tests/test_torch_graphs.py`` and the gloo ranks of
``tests/test_torch_sharding.py`` (``tests/_torch_sharding_ranks.py``)
patch it in; it imports neither JAX nor the reference package.
"""
import collections
import contextlib

import torch

from repro_torch.impact import graphs


class _FakeGraph:
    """Replays by running the body on the static inputs and writing its
    results into the static outputs, as a captured graph would."""

    def __init__(self, fn, inputs, outputs, log):
        self.fn, self.inputs, self.outputs, self.log = fn, inputs, outputs, log

    def replay(self):
        self.log.append("replay")
        _write(self.outputs, self.fn(*self.inputs))


def _write(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        for d, s in zip(dst, src):
            _write(d, s)


class Recorder:
    """Stands in for ``graphs.capture``: runs the body once on the static
    buffers and logs it.  ``launches`` is the record a capture on a card
    would have made (the CPU wrappers launch nothing)."""

    def __init__(self, launches=None, census=None, fail=None):
        self.log = []
        self.launches = collections.Counter(launches or {})
        self.census = census or graphs.Census(kernels=(), other={})
        self.fail = fail
        self.on = True

    @contextlib.contextmanager
    def off(self):
        """Within the block, sessions prepare their entries eagerly."""
        self.on = False
        try:
            yield
        finally:
            self.on = True

    def __call__(self, fn, inputs, pool):
        self.log.append(("capture", tuple(tuple(t.shape) for t in inputs)))
        if self.fail is not None:
            raise RuntimeError(self.fail)
        outputs = fn(*inputs)
        return graphs.Captured(
            graph=_FakeGraph(fn, inputs, outputs, self.log), outputs=outputs,
            launches=collections.Counter(self.launches), census=self.census)


def patch(setattr_, rec: "Recorder") -> "Recorder":
    """Point ``graphs.enabled`` / ``new_pool`` / ``capture`` at ``rec``
    through ``setattr_`` (``monkeypatch.setattr``, or ``setattr`` in a
    process of its own): sessions compiled then capture through it."""
    setattr_(graphs, "enabled", lambda device: rec.on)
    setattr_(graphs, "new_pool", lambda device: None)
    setattr_(graphs, "capture", rec)
    return rec

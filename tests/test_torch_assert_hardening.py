"""The port's serving-path input validation survives ``python -O`` (the
twin of ``tests/test_assert_hardening.py``).

``-O`` strips asserts, so an assert-guarded precondition would silently
admit the bad input in an optimized deployment.  Each of the five
serving-path checks of the reference's test is pinned here on the port
twice: the ``ValueError`` fires in-process, and a ``python -O``
subprocess proves that the check is a real raise.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.serve import engine as engine_mod
from repro_torch.serve import impact_engine as ie
from repro_torch.serve import zoo as zoo_mod

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_aggregate_reports_rejects_empty():
    with pytest.raises(ValueError, match="no reports"):
        ie.aggregate_reports([])


def test_replay_trace_rejects_short_literals():
    # Validation is up front: the engine is never touched, so a None
    # engine proves the raise happens before any serving work.
    with pytest.raises(ValueError, match="one literal row per arrival"):
        ie.replay_trace(None, np.zeros((2, 4), bool), np.zeros(5))


def test_replay_zoo_trace_rejects_short_requests():
    with pytest.raises(ValueError, match="one request per arrival"):
        zoo_mod.replay_zoo_trace(None, [], np.zeros(3))


def test_serve_continuous_rejects_empty_and_ragged():
    with pytest.raises(ValueError, match="at least one request"):
        engine_mod.Engine.serve_continuous(None, [])
    reqs = [engine_mod.Request(rid=0, tokens=np.zeros((4,), np.int32),
                               max_new=1),
            engine_mod.Request(rid=1, tokens=np.zeros((6,), np.int32),
                               max_new=1)]
    with pytest.raises(ValueError, match="equal-length prompts"):
        engine_mod.Engine.serve_continuous(None, reqs)


def test_scatter_cache_rejects_mismatched_trees():
    cache = [torch.zeros((4, 2)), torch.zeros((4, 2))]
    new = [torch.zeros((4, 2))]                    # one leaf short
    axes = [("batch", None), ("batch", None)]
    with pytest.raises(ValueError, match="cache trees disagree"):
        engine_mod._scatter_cache(cache, axes, new,
                                  np.array([0]), np.array([1]))


# The -O proof: one subprocess for every site, under optimized
# semantics, where a bare assert would be compiled away and each call
# below would sail through.
_O_SCRIPT = textwrap.dedent("""
    assert not __debug__, "script must run under python -O"
    import numpy as np
    import torch
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve import impact_engine as ie
    from repro_torch.serve import zoo as zoo_mod

    def expect(fn, *args):
        try:
            fn(*args)
        except ValueError:
            return
        raise SystemExit(f"no ValueError from {fn.__name__} under -O")

    expect(ie.aggregate_reports, [])
    expect(ie.replay_trace, None, np.zeros((2, 4), bool), np.zeros(5))
    expect(zoo_mod.replay_zoo_trace, None, [], np.zeros(3))
    expect(engine_mod.Engine.serve_continuous, None, [])
    expect(engine_mod.Engine.serve_continuous, None, [
        engine_mod.Request(rid=0, tokens=np.zeros((4,), np.int32),
                           max_new=1),
        engine_mod.Request(rid=1, tokens=np.zeros((6,), np.int32),
                           max_new=1)])
    expect(engine_mod._scatter_cache,
           [torch.zeros((4, 2))] * 2, [("batch", None)] * 2,
           [torch.zeros((4, 2))], np.array([0]), np.array([1]))
    print("all serving-path validations held under -O")
""")


def test_validations_survive_python_dash_o():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-O", "-c", _O_SCRIPT],
        capture_output=True, text=True, env=env, cwd=str(REPO))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "held under -O" in res.stdout

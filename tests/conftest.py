"""Shared test fixtures.  NOTE: no XLA_FLAGS here — tests must see the
single real CPU device; multi-device tests spawn subprocesses."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture()
def rng():
    # function-scoped: each test gets a FRESH deterministic stream
    # (a shared session stream makes outcomes depend on test order).
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line("markers", "card: needs a CUDA card; skips "
                            "without one")

"""Each cell's comparison fails its control: the reference's sweep in
TF32, the precision just below the configurations' IEEE f32 with TF32
off, put in the program's place.  On the CPU at a size a test run holds
(TF32 rounded by hand); on a card at the cell's own size, three seeds,
as the limits were set (``perfbench/calibrate.py``)."""
import copy

import pytest

from perfbench import calibrate, harness

CELLS = ["mnist.bulk-fused", "cifar2.bulk-fused", "mnist.bulk-staged"]


def broken(readings, limits):
    return [n for n, lim in limits.items() if not readings[n] <= lim]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_cpu(workload):
    s = copy.deepcopy(harness.spec(workload))
    s["traffic"].update(batch=2048, pool_batches=2)
    assert broken(calibrate.control_readings(s, 2 ** 31 + 5, "cpu"),
                  s["limits"])
    assert not broken(calibrate.program_readings(s, 2 ** 31 + 5, "cpu"),
                      s["limits"])


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(card, workload):
    s = harness.spec(workload)
    for seed in (4_000_000_001, 4_000_000_002, 4_000_000_003):
        assert broken(calibrate.control_readings(s, seed, card), s["limits"])
        assert not broken(calibrate.program_readings(s, seed, card),
                          s["limits"])

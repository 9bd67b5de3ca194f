"""A whole run, the look for a card skipped, with the timed path broken
underneath, comes out not correct: once for each fault a bulk classifier
can have.  (A step that returns its state unchanged and the exchange
between chips do not exist here: the cells train nothing and take one
chip.)"""
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests._tiny import tiny

CELLS = ["mnist.bulk-fused", "cifar2.bulk-fused", "mnist.bulk-staged"]


def half_the_batch(res, m):
    """Only the first half of the lanes computed, the rest copied from
    it."""
    h = res.predictions.shape[0] // 2
    twice = lambda t: torch.cat([t[:h], t[:h]])
    return type(res)(predictions=twice(res.predictions),
                     e_clause_lanes=twice(res.e_clause_lanes),
                     e_class_lanes=twice(res.e_class_lanes))


def one_answer_altered(res, m):
    """One lane's prediction changed to another class where it is
    produced."""
    p = res.predictions.clone()
    p[3] = (p[3] + 1) % m
    return type(res)(predictions=p, e_clause_lanes=res.e_clause_lanes,
                     e_class_lanes=res.e_class_lanes)


def run_cell(workload: str) -> dict:
    return harness.run(tiny(workload), 2 ** 31 + 21, 0.1, False, "cpu",
                       time.perf_counter())


def one_bill_nan(res, m):
    """One lane's clause energy comes out NaN."""
    e = res.e_clause_lanes.clone()
    e[5] = float("nan")
    return type(res)(predictions=res.predictions, e_clause_lanes=e,
                     e_class_lanes=res.e_class_lanes)


@pytest.mark.parametrize("fault", [None, half_the_batch, one_answer_altered,
                                   one_bill_nan],
                         ids=["sound", "half_the_batch", "one_answer_altered",
                              "one_bill_nan"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(monkeypatch, workload, fault):
    from repro_torch.impact.runtime import InferenceSession
    m = tiny(workload)["config"]["n_classes"]
    if fault is not None:
        real = InferenceSession.infer_step
        monkeypatch.setattr(InferenceSession, "infer_step", lambda self, *a,
                            **k: fault(real(self, *a, **k), m))
    r = run_cell(workload)
    assert r["correct"] is (fault is None)
    assert (r["failed"] == 0) is (fault is None)
    assert list(r)[-1] == "checks"


def report_half_billed(real):
    """The batch report sums only the first half of the lanes' energies,
    but counts them all."""
    def step_report(self, e_cl, e_cs, datapoints):
        h = len(e_cl) // 2
        return real(self, e_cl[:h], e_cs[:h], datapoints)
    return step_report


def report_miscounted(real):
    """The batch report counts one datapoint fewer than it bills."""
    def step_report(self, e_cl, e_cs, datapoints):
        return real(self, e_cl, e_cs, datapoints - 1)
    return step_report


# The report's read energy is compared in the MNIST cells only (PERF.md
# section 2); its count in every cell.
@pytest.mark.parametrize("workload, fault, number", [
    ("mnist.bulk-fused", report_half_billed, "report"),
    ("mnist.bulk-staged", report_half_billed, "report"),
    ("mnist.bulk-fused", report_miscounted, "report_count"),
    ("cifar2.bulk-fused", report_miscounted, "report_count"),
    ("mnist.bulk-staged", report_miscounted, "report_count"),
])
def test_report_fault_is_not_correct(monkeypatch, workload, fault, number):
    from repro_torch.impact.pipeline import IMPACTSystem
    monkeypatch.setattr(IMPACTSystem, "step_report",
                        fault(IMPACTSystem.step_report))
    r = run_cell(workload)
    assert r["correct"] is False and r["failed"] > 0
    assert not r["checks"][number]["value"] <= r["checks"][number]["limit"]

"""Every file BENCHMARK.json names loads by name, and each metric reader
reads a run."""
import json

import pytest

from perfbench import harness
from perfbench.families import cotm

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_loads_by_name(workload):
    s = harness.spec(workload)
    cfg, traffic = s["config"], s["traffic"]
    assert cfg["name"] == s["cell"]["config"]
    assert traffic["name"] == s["cell"]["traffic"]
    assert (harness.ROOT / cfg["reference"]).is_file()
    assert s["limits"] and set(s["limits"]) <= set(cotm.CHECKS)
    assert s["limits"].pop("report_count") == 0    # exact, in every cell
    assert all(0 < v < 1e-3 for v in s["limits"].values())
    names = {m["name"] for m in s["end_to_end"]}
    assert {"setup_s", "datapoints_per_s", "batch_ms_p95"} <= names
    assert s["per_layer"]


def test_configurations_are_files_of_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_metric_reads_a_run(metric):
    from perfbench.yardstick.trace import Trace
    run = harness.Run(setup_s=8.0, window_s=10.0, batches=100,
                      datapoints=100 * 16384, batch_s=[1e-3] * 100,
                      spans={"session.infer_step": 0.01, "results": 0.05,
                             "billing": 0.02},
                      launches=100, flops_per_datapoint=0.796e6,
                      sweep_bound_s=0.19e-3,
                      trace=Trace(busy_s=1.5, window_s=2.0, kernel_s=1.2,
                                  batches=1000))
    v = harness.reader(metric)(run)
    assert isinstance(v, float) and v > 0
    if metric.endswith("roofline") or "mfu" in metric:
        assert v <= 100


@pytest.mark.parametrize("metric", ["kernel_roofline", "device_idle_share"])
def test_trace_metric_without_trace_reads_nothing(metric):
    run = harness.Run(1.0, 1.0, 1, 1, [1.0], {}, 0, 1.0, 1.0, trace=None)
    assert harness.reader(metric)(run) is None

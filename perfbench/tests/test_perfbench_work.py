"""The frozen work count against arithmetic by hand."""
import pytest

from perfbench import harness
from perfbench.families import cotm
from perfbench.tests._tiny import tiny
from perfbench.yardstick import work

B = 16384


@pytest.mark.parametrize("workload, per_datapoint, bound_ms", [
    # 784 driven rows over 500 clause columns and the meter, 500 x 10
    # class cells: 0.796 MFLOP, half the dense 2 (K n + n m) = 1.578.
    ("mnist.bulk-fused", 2 * 784 * 501 + 2 * 500 * 10, 0.19455),
    # 1024 driven rows over 1000 columns and the meter, 1000 x 2: 2.054
    # MFLOP, half the dense 4.1.
    ("cifar2.bulk-fused", 2 * 1024 * 1001 + 2 * 1000 * 2, 0.50229),
])
def test_metered_sweep_per_datapoint(workload, per_datapoint, bound_ms):
    c = harness.spec(workload)["config"]
    K, n, m = c["n_literals"], c["n_clauses"], c["n_classes"]
    flops, moved = work.metered_sweep(B, K, K // 2, n, m)
    assert flops == B * per_datapoint
    assert moved == B * K + (K * n + K + n * m) * 4 + 3 * B * 4
    t, what = work.bound_s(moved, flops)
    assert what == "operations" and t == pytest.approx(flops / 67e12)
    assert t * 1e3 == pytest.approx(bound_ms, rel=1e-4)


def test_bound_by_bytes():
    t, what = work.bound_s(3.35e12, 1.0)
    assert what == "bytes" and t == pytest.approx(1.0)


@pytest.mark.parametrize("workload", ["mnist.bulk-fused", "cifar2.bulk-fused"])
def test_cell_counts_the_rows_its_pool_drives(workload):
    s = tiny(workload)
    cell = cotm.Cell(s["config"], s["traffic"], 2 ** 31 + 3, "cpu")
    K, n = s["config"]["n_literals"], int(cell.dep.nonempty.sum())
    m, Bt = s["config"]["n_classes"], s["traffic"]["batch"]
    flops, moved = work.metered_sweep(Bt, K, K // 2, n, m)
    assert cell.flops_per_datapoint * Bt == pytest.approx(flops)
    assert cell.sweep_bound_s == work.bound_s(moved, flops)[0]

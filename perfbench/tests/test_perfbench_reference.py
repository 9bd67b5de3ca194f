"""The plain reference against its definition, a loop over every cell of
every datapoint, at a tiny size."""
import pytest
import torch

from perfbench.families import cotm
from perfbench.references import cotm as reference
from perfbench.tests._tiny import tiny


@pytest.mark.parametrize("workload", ["mnist.bulk-fused", "cifar2.bulk-fused"])
def test_sweep_matches_datapoint_loop(workload):
    s = tiny(workload, batch=6, pool_batches=1)
    gen = torch.Generator().manual_seed(11)
    dep = cotm.deploy(s["config"], gen)
    lits = cotm.pool(dep, s["traffic"], gen)[0]
    scores, e_cl, e_cs = reference.sweep(lits, dep.clause_g, dep.nonempty,
                                         dep.class_g, block=4)
    assert scores.dtype == e_cl.dtype == e_cs.dtype == torch.float64
    for b in range(lits.shape[0]):
        want, w_cl, w_cs = reference.datapoint(lits[b], dep.clause_g,
                                               dep.nonempty, dep.class_g)
        torch.testing.assert_close(scores[b], want, rtol=1e-12, atol=0)
        assert float(e_cl[b]) == pytest.approx(w_cl, rel=1e-12)
        assert float(e_cs[b]) == pytest.approx(w_cs, rel=1e-12, abs=1e-30)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 3.1e-6])
    y = reference.to_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0            # a tie rounds to even
    assert y[2] == 1.0 + 2 ** -9
    assert (y.view(torch.int32) & 0x1FFF).eq(0).all()
    assert float((y[3] - x[3]).abs() / x[3]) <= 2 ** -11

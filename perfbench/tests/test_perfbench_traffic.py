"""The traffic pool: the same for the same seed, another for another,
exactly K/2 driven rows a datapoint, at the configurations' own sizes."""
import pytest
import torch

from perfbench import harness
from perfbench.families import cotm


def draw(workload, seed, batch=256, pool_batches=2):
    s = harness.spec(workload)
    gen = torch.Generator().manual_seed(seed)
    dep = cotm.deploy(s["config"], gen)
    return dep, cotm.pool(dep, dict(s["traffic"], batch=batch,
                                    pool_batches=pool_batches), gen)


@pytest.mark.parametrize("workload", ["mnist.bulk-fused", "cifar2.bulk-fused"])
def test_pool_is_the_seeds(workload):
    big = 2 ** 31 + 97          # a run's seed may pass 32 signed bits
    dep, a = draw(workload, big)
    _, b = draw(workload, big)
    _, c = draw(workload, big + 1)
    K = dep.n_literals
    assert len(a) == 2
    for x, y, z in zip(a, b, c):
        assert x.shape == (256, K) and x.dtype == torch.int8
        assert torch.equal(x, y)
        assert not torch.equal(x, z)
        # [bits, ~bits]: every datapoint drives exactly K/2 rows.
        assert torch.equal(x[:, :K // 2], 1 - x[:, K // 2:])
        assert (x == 0).sum(dim=1).eq(K // 2).all()


@pytest.mark.parametrize("workload", ["mnist.bulk-fused", "cifar2.bulk-fused"])
def test_deployment(workload):
    from perfbench.yardstick.yflash import G_HCS_BOOL, G_LCS
    dep, (lits, _) = draw(workload, 5)
    c = harness.spec(workload)["config"]
    n, K = c["n_clauses"], c["n_literals"]
    R, C, tr, tc = dep.clause_g.shape
    assert (R * tr, C * tc) == (-(-K // 2048) * 2048, -(-n // 512) * 512)
    g = dep.clause_g.permute(0, 2, 1, 3).reshape(R * tr, C * tc)
    include = torch.cat([dep.pos, dep.neg])
    # Every clause nonempty; included cells HCS, every other cell LCS.
    assert include.any(dim=0).all() and dep.nonempty[:n].all()
    assert not dep.nonempty[n:].any()
    assert (g[:K, :n][include] > G_HCS_BOOL).all()
    assert (g[:K, :n][~include] < G_LCS).all()
    assert (g[K:] < G_LCS).all() and (g[:, n:] < G_LCS).all()
    assert not (dep.pos & dep.neg).any()
    # The share of its own class's clauses a datapoint fires is about the
    # configured one, and no datapoint fires nothing.
    from perfbench.references import cotm as reference
    scores, _, _ = reference.sweep(lits, dep.clause_g, dep.nonempty,
                                   dep.class_g)
    assert (scores.sum(dim=1) > 0).all()

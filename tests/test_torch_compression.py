"""The port's clause pruning (``repro_torch.train.prune_clauses``) held
against the JAX reference's on the reference's crafted calibration
systems, carried across as arrays, and the session cache of a system
copied with ``dataclasses.replace``.

Contracts: ``PruneStats`` equal field for field, with
``energy_per_effective_clause_j`` at rel 1e-6 (the port sums the meters
in f64, the reference in f32); the pruned ``clause_i``, ``clause_g``,
``class_i``, ``class_g`` and ``nonempty`` equal the reference's exactly
(the duplicate merge adds the class rows in f32 in the reference's
order, and ``class_g`` is the same numpy expression of the same
currents); predictions on the calibration batch exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.impact import RuntimeSpec as JSpec
from repro.train.compression import prune_clauses as jprune
from repro_torch.convert import system_from_arrays
from repro_torch.impact import RuntimeSpec, energy
from repro_torch.impact.yflash import I_CSA_THRESHOLD
from repro_torch.kernels import ref
from repro_torch.train import PruneStats, prune_clauses
from test_fused_impact import _make_system

FIELDS = ("clause_i", "clause_g", "class_i", "class_g", "nonempty")


def _carry(jsys):
    """A JAX system as the port's, on the CPU."""
    d = {f: np.array(getattr(jsys, f)) for f in FIELDS}
    d.update(n_literals=jsys.n_literals, n_clauses=jsys.n_clauses,
             n_classes=jsys.n_classes, program_energy_j=1.5e-3,
             erase_energy_j=2.5e-9)
    return system_from_arrays(d, device="cpu")


def _calib_system(seed=0):
    """The reference's calibration system (``tests/test_compression.py``):
    column 5 copies column 3's cells, and the literal mix leaves some
    clauses never firing.  -> (numpy literals, JAX system, port system)."""
    lit, jsys = _make_system(64, 100, 80, 6, 2, 64, 2, 50, 2, 50, seed=seed)
    ci = np.array(jsys.clause_i)
    cg = np.array(jsys.clause_g)
    ci[:, 0, :, 5] = ci[:, 0, :, 3]
    cg[:, 0, :, 5] = cg[:, 0, :, 3]
    jsys = dataclasses.replace(jsys, clause_i=jnp.asarray(ci),
                               clause_g=jnp.asarray(cg))
    jsys.encode_stats = dict(program_energy_j=1.5e-3, erase_energy_j=2.5e-9)
    return np.array(lit), jsys, _carry(jsys)


def _predict(system, lit, **spec):
    return system.compile(RuntimeSpec(device="cpu", **spec)).predict(
        lit).predictions


@pytest.mark.parametrize("seed", [0, 1, 2, 4])
@pytest.mark.parametrize("merge", [True, False])
def test_prune_matches_jax(seed, merge):
    """Stats, the pruned crossbars and the record equal the reference's;
    predictions on the calibration batch are unchanged."""
    lit, jsys, tsys = _calib_system(seed)
    jp, jst = jprune(jsys, jnp.asarray(lit), merge_duplicates=merge)
    tp, tst = prune_clauses(tsys, lit, merge_duplicates=merge)
    assert isinstance(tst, PruneStats)
    for f in dataclasses.fields(PruneStats):
        a, b = getattr(tst, f.name), getattr(jst, f.name)
        if f.name == "energy_per_effective_clause_j":
            np.testing.assert_allclose(a, b, rtol=1e-6)
        else:
            assert a == b, f.name
    assert tst.n_never_fired >= 1
    if not merge:
        assert tst.n_duplicates == 0
    elif seed == 0:
        assert tst.n_duplicates >= 1     # the crafted copy fires and merges
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), f)
    assert tp.encode_stats["pruning"] == dataclasses.asdict(tst)
    assert tp.encode_stats["program_energy_j"] == 1.5e-3
    assert tp.device == tsys.device
    assert torch.equal(_predict(tp, lit), _predict(tsys, lit))
    np.testing.assert_array_equal(
        _predict(tp, lit, backend="torch").numpy(),
        np.asarray(jsys.compile(JSpec(backend="xla")).predict(
            jnp.asarray(lit)).predictions))


def test_prune_erases_retired_columns_physically():
    """Retired columns: currents and conductances 0, nonempty cleared, so
    the clause meter bills strictly less than the unpruned system's."""
    lit, _, tsys = _calib_system(seed=1)
    pruned, stats = prune_clauses(tsys, lit)
    ne_old = tsys._nonempty_eff().numpy()
    ne_new = pruned._nonempty_eff().numpy()
    dead = ne_old & ~ne_new
    n_nonempty = int(ne_old.sum())
    assert stats.n_effective + stats.n_never_fired + stats.n_duplicates \
        == n_nonempty
    assert dead.sum() == stats.n_never_fired + stats.n_duplicates
    C, tc = tsys.clause_i.shape[1], tsys.clause_i.shape[3]
    dead_cols = dead.reshape(C, tc)
    for f in ("clause_i", "clause_g"):
        cells = getattr(pruned, f).numpy().transpose(1, 3, 0, 2)
        assert (cells[dead_cols] == 0).all(), f

    def clause_meter(s):
        _, i_cl, _ = ref.fused_impact_metered_ref(
            torch.from_numpy(lit), s.clause_i, s._nonempty_eff(), s.class_i,
            thresh=I_CSA_THRESHOLD)
        return float(i_cl.double().sum())

    assert clause_meter(pruned) < clause_meter(tsys)


def test_prune_without_merge_keeps_class_rows():
    lit, _, tsys = _calib_system(seed=2)
    _, merged = prune_clauses(tsys, lit)
    pruned, stats = prune_clauses(tsys, lit, merge_duplicates=False)
    assert stats.n_duplicates == 0
    assert stats.n_effective == merged.n_effective + merged.n_duplicates
    assert torch.equal(pruned.class_i, tsys.class_i)
    assert torch.equal(pruned.class_g, tsys.class_g)


def test_prune_degenerate_nothing_fires():
    """All-zero literals drive every row, so no clause fires: every
    nonempty column retires, the figure reports 0.0, and the pruned
    system scores 0 A everywhere."""
    lit, jsys = _make_system(8, 100, 50, 4, 2, 64, 1, 64, 1, 64, seed=3)
    tsys = _carry(jsys)
    pruned, stats = prune_clauses(tsys, np.zeros(lit.shape, bool))
    _, jst = jprune(jsys, jnp.zeros_like(lit))
    assert dataclasses.asdict(stats) == dataclasses.asdict(jst)
    assert stats.n_effective == 0
    assert stats.energy_per_effective_clause_j == 0.0
    assert not bool(pruned._nonempty_eff().any())
    scores = pruned.compile(RuntimeSpec(device="cpu")).predict(
        np.array(lit)).scores
    assert (scores == 0.0).all()
    assert energy.energy_per_effective_clause(1.0, 0, 5) == 0.0
    assert energy.energy_per_effective_clause(1.0, 4, 5) == 1.0 / 4 / 5


@pytest.mark.parametrize("backend", ["cuda", "cuda-packed", "torch"])
def test_prune_stacks_with_packing(backend):
    """Pruned + ``packing="2bit"`` predicts what the unpruned unpacked
    session predicts on the calibration batch."""
    lit, _, tsys = _calib_system(seed=4)
    pruned, _ = prune_clauses(tsys, lit)
    for metering in ("off", "fused"):
        got = _predict(pruned, lit, backend=backend, packing="2bit",
                       metering=metering)
        assert torch.equal(got, _predict(tsys, lit, backend="torch"))


def test_replaced_system_gets_its_own_sessions():
    """``dataclasses.replace`` (as ``prune_clauses`` builds the pruned
    system) must not share the session cache: each system compiles its
    own session, which reads its own operands."""
    lit, _, tsys = _calib_system(seed=0)
    spec = RuntimeSpec(backend="torch", device="cpu")
    old = tsys.compile(spec)
    ne = torch.zeros_like(tsys.nonempty)
    new_sys = dataclasses.replace(tsys, nonempty=ne)
    new = new_sys.compile(spec)
    assert new is not old
    assert tsys.compile(spec) is old and new_sys.compile(spec) is new
    assert new.system is new_sys and old.system is tsys
    assert not bool(new._nonempty.any())
    assert bool(old._nonempty.any())
    assert (new.predict(lit).scores == 0.0).all()
    assert bool((old.predict(lit).scores != 0.0).any())

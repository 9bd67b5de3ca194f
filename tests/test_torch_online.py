"""The port's online in-memory trainer (``repro_torch.train.OnlineTrainer``)
held against the JAX reference's (``repro.train.OnlineTrainer``), and the
port's own contracts: the session picks up every write, the write meter
is a fold of the per-update bills, and serving interleaves with updates.

Parity runs on ideal devices (``variability=False``: no D2D spread, no
C2C noise, so no draws on the write path), on the reference's own
deployed system carried across as arrays, with the feedback draws
injected: the uniforms behind the reference's Bernoulli masks, from the
same split keys (``train/online.py:187``).

Tolerances: TA states, weights, flip counts, pulse counts and write
energies are exact.  Conductances after the write-back are held to
p * 2**-23 relative for p pulses: ``exp`` of a pulse's decay exponent
can round one f32 ulp apart in XLA and PyTorch (ROADMAP Queue 3), and the
pulse loop multiplies by it once per pulse.  Such an ulp could in
principle move a class cell across a band edge and change a pulse count;
the exact checks would then fail on that count, and the message says so.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cotm import CoTMConfig as JConfig
from repro.core.train import train_step_batch
from repro.data.synthetic import prototype
from repro.impact import RuntimeSpec as JSpec
from repro.impact.pipeline import IMPACTConfig as JIMPACTConfig
from repro.impact.pipeline import build_system as jbuild
from repro.train import OnlineTrainer as JTrainer
from repro_torch.convert import params_from_arrays, system_from_arrays
from repro_torch.core.cotm import CoTMConfig
from repro_torch.core.cotm import predict as digital_predict
from repro_torch.core.train import FeedbackDraws
from repro_torch.impact import (IMPACTConfig, RuntimeSpec, build_coresident,
                                build_system)
from repro_torch.impact.runtime import InferenceSession
from repro_torch.serve import IMPACTEngine
from repro_torch.tracing import Tracer, validate_events
from repro_torch.train import OnlineTrainer

KW = dict(n_literals=64, n_clauses=40, n_classes=4, n_states=64,
          threshold=16, specificity=4.0)
B = 64


def _prototype_problem(seed=3, n_train=512, n_holdout=128):
    """The reference's ``tests/test_online_training.py`` problem."""
    x, y = prototype(n_train + n_holdout, n_classes=4, n_features=32,
                     flip=0.05, seed=seed)
    lits = np.concatenate([x, 1 - x], -1).astype(bool)
    y = y.astype(np.int32)
    return ((lits[:n_train], y[:n_train]), (lits[n_train:], y[n_train:]))


def _jax_deployed(tr_l, tr_y, pretrain_batches=8, seed=0):
    """The reference's half-trained deployment on ideal devices."""
    cfg = JConfig(**KW)
    params = cfg.init(jax.random.key(seed))
    key = jax.random.key(seed + 1)
    for b in range(pretrain_batches):
        key, k = jax.random.split(key)
        sl = slice(b * B, (b + 1) * B)
        params = train_step_batch(params, jnp.asarray(tr_l[sl]),
                                  jnp.asarray(tr_y[sl]), k, cfg)
    system = jbuild(params, cfg, jax.random.key(seed + 2),
                    JIMPACTConfig(variability=False, finetune=False))
    return cfg, params, system


def _system_arrays(jsys):
    """The reference's programmed system as ``system_from_arrays`` takes
    it."""
    d = {f: np.asarray(getattr(jsys, f)) for f in
         ("clause_g", "nonempty", "class_g", "clause_i", "class_i")}
    st = jsys.encode_stats
    d.update(n_literals=jsys.n_literals, n_clauses=jsys.n_clauses,
             n_classes=jsys.n_classes,
             program_energy_j=st["program_energy_j"],
             erase_energy_j=st["erase_energy_j"],
             weight_shift=int(st["weight_shift"]),
             w_max=int(st["weights"]["w_max"]),
             cfg=dataclasses.asdict(jsys.cfg))
    return d


def _update_draws(key, cfg):
    """The feedback draws of the reference's ``update(key)``: its key
    splits into (neg, sel, hi, lo, write C2C clause, write C2C class)."""
    K, n, m = cfg.n_literals, cfg.n_clauses, cfg.n_classes
    k_neg, k_sel, k_hi, k_lo, _, _ = jax.random.split(key, 6)
    t = lambda a: torch.from_numpy(np.array(a))
    return FeedbackDraws(
        neg_offset=t(jax.random.randint(k_neg, (B,), 1, m)),
        u_sel=t(jax.random.uniform(k_sel, (2 * B, n))),
        u_lo=t(jax.random.uniform(k_lo, (K, n))),
        u_hi=t(jax.random.uniform(k_hi, (K, n))))


@pytest.fixture(scope="module")
def jax_run():
    """Three ideal-device updates of the reference trainer: its deployed
    system as arrays, and per update the keys, record and state."""
    (tr_l, tr_y), _ = _prototype_problem()
    jcfg, jparams, jsys = _jax_deployed(tr_l, tr_y)
    start = (_system_arrays(jsys), np.asarray(jparams.ta_state),
             np.asarray(jparams.weights))
    jt = JTrainer(jsys.compile(JSpec(backend="xla")), jparams, jcfg,
                  key=jax.random.key(11), variability=False)
    steps = []
    for step in range(3):
        key = jax.random.key(100 + step)
        sl = slice(step * B, (step + 1) * B)
        rec = jt.update(jnp.asarray(tr_l[sl]), jnp.asarray(tr_y[sl]),
                        key=key)
        steps.append(dict(
            draws=_update_draws(key, jcfg), batch=(tr_l[sl], tr_y[sl]),
            record=rec, ta=np.asarray(jt.params.ta_state),
            w=np.asarray(jt.params.weights),
            **{f: np.asarray(getattr(jsys, f))
               for f in ("clause_g", "class_g", "nonempty")}))
    return start, steps, jt.write_energy_j


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_trajectory_matches_jax_trainer(jax_run, backend):
    """Three ideal-device updates: the port's trainer (plain versions, or
    the ``"cuda"`` backend's routing on CPU tensors) walks the reference
    trainer's TA/weight trajectory bit for bit, with the same flips, pulse
    counts and write energies."""
    (arrays, ta, w), steps, j_meter = jax_run
    tsys = system_from_arrays(arrays, device="cpu")
    tt = OnlineTrainer(
        tsys.compile(RuntimeSpec(backend=backend, device="cpu")),
        params_from_arrays(ta, w, device="cpu"), CoTMConfig(**KW),
        generator=torch.Generator(), variability=False)
    for i, st in enumerate(steps):
        tr, jr = tt.update(*st["batch"], draws=st["draws"]), st["record"]
        np.testing.assert_array_equal(tt.params.ta_state.numpy(), st["ta"])
        np.testing.assert_array_equal(tt.params.weights.numpy(), st["w"])
        for k in ("n_flips", "n_weight_cells", "prog_pulses",
                  "erase_pulses", "n_unconverged", "write_energy_j"):
            assert tr[k] == jr[k], (
                f"update {i}: {k} {tr[k]} != {jr[k]} (a one-ulp exp "
                f"difference can move a class cell across a band edge)")
        np.testing.assert_allclose(tr["read_energy_j"], jr["read_energy_j"],
                                   rtol=1e-5)
        pulses = max(jr["prog_pulses"], jr["erase_pulses"], 1)
        for f in ("clause_g", "class_g"):
            np.testing.assert_allclose(getattr(tsys, f).numpy(), st[f],
                                       rtol=pulses * 2.0 ** -23, atol=0)
        np.testing.assert_array_equal(tsys.nonempty.numpy(), st["nonempty"])
    assert sum(r["n_flips"] for r in tt.records) > 0
    assert tt.write_energy_j == j_meter


def _port_deployed(variability, seed=0, pretrain=8):
    """A half-trained port deployment of the prototype problem."""
    from repro_torch.core.train import train_step_batch as tstep
    (tr_l, tr_y), held_out = _prototype_problem()
    cfg = CoTMConfig(**KW)
    gen = torch.Generator().manual_seed(seed)
    params = cfg.init(gen)
    for b in range(pretrain):
        sl = slice(b * B, (b + 1) * B)
        params = tstep(params, torch.from_numpy(tr_l[sl]),
                       torch.from_numpy(tr_y[sl]), gen, cfg)
    system = build_system(params, cfg, gen,
                          IMPACTConfig(variability=variability,
                                       finetune=variability), device="cpu")
    return cfg, params, system, (tr_l, tr_y), held_out


def test_sessions_serve_the_written_conductances():
    """After an update, a session compiled before it (the trainer's own,
    and another cached on the system) predicts what a session built fresh
    on the mutated system predicts: no session keeps serving the old
    conductances."""
    cfg, params, system, (tr_l, tr_y), (ho_l, _) = _port_deployed(False)
    spec = RuntimeSpec(backend="torch", device="cpu")
    session = system.compile(spec)
    other = system.compile(RuntimeSpec(backend="cuda", metering="fused",
                                       device="cpu"))
    before = session.predict(ho_l).scores
    trainer = OnlineTrainer(session, params, cfg,
                            generator=torch.Generator().manual_seed(1),
                            variability=False)
    for b in range(2):
        trainer.update(tr_l[b * B:(b + 1) * B], tr_y[b * B:(b + 1) * B])
    assert sum(r["n_flips"] for r in trainer.records) > 0
    fresh = InferenceSession(system, spec).predict(ho_l)
    assert not torch.equal(fresh.scores, before)
    for sess in (session, other):
        got = sess.predict(ho_l)
        assert torch.equal(got.predictions, fresh.predictions)
        assert torch.equal(got.scores, fresh.scores)


def test_write_meter_is_a_left_fold_of_the_bills():
    """The running write meter equals a left fold of the per-update bills
    and of the reports' write lanes, exactly.  A left fold, not ``sum()``:
    from Python 3.12 ``sum()`` of floats is compensated (Neumaier), so it
    can differ in the last ulp from the trainer's running ``+=``."""
    cfg, params, system, (tr_l, tr_y), _ = _port_deployed(True)
    trainer = OnlineTrainer(system.compile(RuntimeSpec(device="cpu")),
                            params, cfg,
                            generator=torch.Generator().manual_seed(3),
                            variability=True)
    for step in range(4):
        r = trainer.update(tr_l[step * B:(step + 1) * B],
                           tr_y[step * B:(step + 1) * B])
        assert r["write_energy_j"] >= 0.0
        assert (r["write_energy_j"] == 0.0) == (
            r["prog_pulses"] + r["erase_pulses"] == 0)
    fold_records, fold_reports = 0.0, 0.0
    for r, rep in zip(trainer.records, trainer.reports):
        fold_records += r["write_energy_j"]
        fold_reports += rep.write_energy_j
    assert fold_records == trainer.write_energy_j
    assert fold_reports == trainer.write_energy_j
    assert trainer.write_energy_j > 0.0


def test_interleaved_train_serve_improves_and_reconciles():
    """Updates interleave with ``IMPACTEngine`` sweeps on the same session:
    held-out accuracy through ``session.predict`` improves, the serving
    entries are prepared once, request bills reconcile with the batch
    meter at 1e-9, the ``ta_feedback`` entry is counted once, and the
    trace carries one balanced span per update."""
    cfg, params, system, (tr_l, tr_y), (ho_l, ho_y) = _port_deployed(False)
    session = system.compile(RuntimeSpec(backend="cuda", metering="fused",
                                         capacity=B, device="cpu"))
    trace = Tracer()
    trainer = OnlineTrainer(session, params, cfg,
                            generator=torch.Generator().manual_seed(7),
                            variability=False, trace=trace)
    engine = IMPACTEngine(session)
    acc0 = trainer.evaluate(ho_l, ho_y)
    traces0 = dict(session._traces)
    for epoch in range(2):
        for b in range(0, 512, B):
            preds, stats = engine.run(tr_l[b:b + B])
            bills = 0.0
            for rec in engine.request_records[-B:]:
                bills += rec.e_read_j
            np.testing.assert_allclose(bills,
                                       stats["energy"].read_energy_j,
                                       rtol=1e-9, atol=0)
            assert stats["energy"].write_energy_j == 0.0
            trainer.update(tr_l[b:b + B], tr_y[b:b + B])
    acc1 = trainer.evaluate(ho_l, ho_y)
    assert acc1 > acc0, (acc0, acc1)
    for entry in ("infer_step", "predict"):
        assert session._traces[entry] == traces0[entry]
    assert session._traces["ta_feedback"] == 1
    assert session.is_compiled("ta_feedback", 2 * B)
    dp = digital_predict(trainer.params, torch.from_numpy(ho_l), cfg)
    ap = session.predict(ho_l).predictions
    assert float((dp == ap).float().mean()) > 0.7
    events = trace.to_json()
    validate_events(events)
    spans = [e for e in events if e["name"] == "train_update"]
    assert len(spans) == 2 * len(trainer.records)


def test_trainer_rejects_sessions_it_cannot_write():
    """The trainer refuses a packed session (``packing="2bit"``, or any
    session on ``"cuda-packed"``: the write path targets the f32
    conductance grid) and a co-resident one (a write would re-program the
    shared fabric), as the reference does
    (``tests/test_online_training.py``)."""
    cfg, params, system, _, _ = _port_deployed(False, pretrain=1)
    for spec in (RuntimeSpec(device="cpu", packing="2bit"),
                 RuntimeSpec(backend="cuda-packed", device="cpu")):
        with pytest.raises(ValueError, match="unpacked"):
            OnlineTrainer(system.compile(spec), params, cfg,
                          generator=torch.Generator())
    combined, plan = build_coresident([system, system])
    co = combined.compile(RuntimeSpec(backend="torch", device="cpu",
                                      coresident=plan))
    with pytest.raises(ValueError, match="single-tenant"):
        OnlineTrainer(co, params, cfg, generator=torch.Generator())


def test_packed_sessions_are_repacked_after_a_write():
    """After an ideal-device update through an unpacked session, a packed
    session compiled before it on the same system serves what a fresh
    packed session on the written system serves: the trainer's refresh
    re-packs it."""
    cfg, params, system, (tr_l, tr_y), (ho_l, _) = _port_deployed(False)
    spec = RuntimeSpec(backend="cuda", packing="2bit", metering="fused",
                       device="cpu")
    packed = system.compile(spec)
    bits_before = packed._packed.bits.clone()
    trainer = OnlineTrainer(system.compile(RuntimeSpec(device="cpu")),
                            params, cfg,
                            generator=torch.Generator().manual_seed(1),
                            variability=False)
    trainer.update(tr_l[:B], tr_y[:B])
    assert trainer.records[0]["n_flips"] > 0
    fresh = InferenceSession(system, spec)
    assert not torch.equal(fresh._packed.bits, bits_before)
    assert torch.equal(packed._packed.bits, fresh._packed.bits)
    assert torch.equal(packed._packed.levels, fresh._packed.levels)
    got, want = packed.predict(ho_l), fresh.predict(ho_l)
    assert torch.equal(got.predictions, want.predictions)
    assert torch.equal(got.scores, want.scores)

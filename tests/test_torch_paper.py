"""The paper's experiments on the port (``repro_torch.paper``) against the
reference's scripts (``benchmarks/*.py``, loaded as the namespace package
``benchmarks`` for their constants and small functions; their ``main``
and ``benchmarks.common.trained_mnist_cotm`` never run here), on the CPU
at small sizes.

Contracts and tolerances:

* (a) every paper constant dict equals the reference's;
* (b) Table 4 on the reference's ideal-device system (K = 64, 48
  clauses, 4 classes, ``max_tile_cols=32``: two column tiles) carried
  across by ``system_from_arrays``: pulse, read and worst-case column
  energies at rtol 1e-6 (f32 read currents; the column sums 2048 equal
  f32 terms in another order); staged and fused pJ a datapoint and
  TOPS/W at rtol 1e-5 (``EnergyReport`` fields, the session contract of
  ``tests/test_torch_runtime.py``); GOPS, areas and accuracies exact;
  predictions equal;
* (c) the Table 6 ratios from that report at rtol 1e-5 (TOPS/W's);
* (d) Fig. 13 on ideal devices from reference-trained iris-sized
  weights and from the Table 4 system's random ones (wider weights, so
  the budgets part): every cost equal, accuracies and mean pulse counts
  at the f32 rounding of the reference's means (``RTOL_F32_MEAN``), the
  adaptive row's mean error in segments at rtol 1e-5;
* (e) ``c2c`` / ``d2d`` with the pulse noise off on the reference's
  ``DeviceVariation`` arrays: pulse counts equal, conductances at rtol
  ``RTOL_TRAJECTORY`` (PyTorch's and XLA's f32 ``exp`` may differ by
  one ulp, 2**-23 relative, and a cell's conductance compounds one such
  factor a pulse: ``c2c`` carries one device through
  ``C2C_CYCLES_IDEAL`` cycles of two loops of at most 128 pulses,
  ``d2d`` through two loops of at most 256; measured: 2.0e-6 and
  3.2e-6);
* (f) with the noise on (independent draws), the port's ``c2c(20)`` /
  ``d2d(50)`` means within ``N_SE`` standard errors of their difference
  from the reference's at the same sizes;
* (g) ``table5_dataset`` equal for all seven names; on ideal devices the
  port's software and hardware accuracy of reference-trained iris-sized
  parameters equal the reference's ``run_dataset`` (at ``RTOL_F32_MEAN``);
* (h) ``python -m repro_torch.paper --device cpu --only fig7_8`` prints
  the reference's row names; a section that raises prints its ERROR row
  and makes the run exit 1; without a card the run raises.
"""
import ast
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import fig7_8_variability as r_f78  # noqa: E402
from benchmarks import fig13_tuning_sweep as r_f13  # noqa: E402
from benchmarks import table4_energy as r_t4  # noqa: E402
from benchmarks import table5_datasets as r_t5  # noqa: E402
from benchmarks import table6_comparison as r_t6  # noqa: E402
from repro.core import CoTMConfig as JConfig  # noqa: E402
from repro.core import CoTMParams as JParams  # noqa: E402
from repro.core import include_mask as j_include_mask  # noqa: E402
from repro.data import synthetic as j_synthetic  # noqa: E402
from repro.impact import IMPACTConfig as JImpactConfig  # noqa: E402
from repro.impact import RuntimeSpec as JSpec  # noqa: E402
from repro.impact import build_system as j_build_system  # noqa: E402
from repro.impact import yflash as jy  # noqa: E402
from repro_torch.convert import params_from_arrays, system_from_arrays  # noqa: E402
from repro_torch.core import CoTMConfig, predict  # noqa: E402
from repro_torch.data import synthetic as t_synthetic  # noqa: E402
from repro_torch.impact import IMPACTConfig, RuntimeSpec  # noqa: E402
from repro_torch.impact.yflash import DeviceVariation  # noqa: E402
from repro_torch.paper import __main__ as cli  # noqa: E402
from repro_torch.paper import common  # noqa: E402
from repro_torch.paper import fig7_8_variability as f78  # noqa: E402
from repro_torch.paper import fig13_tuning_sweep as f13  # noqa: E402
from repro_torch.paper import table4_energy as t4  # noqa: E402
from repro_torch.paper import table5_datasets as t5  # noqa: E402
from repro_torch.paper import table6_comparison as t6  # noqa: E402

K, N_CLAUSES, M, N_STATES, B = 64, 48, 4, 128, 96
RTOL_CELL = 1e-6
RTOL_REPORT = 1e-5
RTOL_SEGMENTS = 1e-5
# The reference's accuracies and mean pulse counts are f32 means (the
# port's are f64): equal counts agree to the f32 rounding of the mean.
RTOL_F32_MEAN = 2.0 ** -23
C2C_CYCLES_IDEAL = 4
# One f32 ulp a pulse over the most pulses either function can take.
RTOL_TRAJECTORY = C2C_CYCLES_IDEAL * 128 * 2.0 ** -23
N_SE = 4.0
IRIS_TRAIN, IRIS_EPOCHS = 300, 2


# -- fixtures -----------------------------------------------------------------

@pytest.fixture(scope="module")
def table4_systems():
    """The reference's ideal-device system at K = 64, n = 48, m = 4 with
    two 32-column clause tiles, the port's copy of it, a batch that fires
    clauses and the port's ``Trained`` for it (labels: the digital CoTM's
    predictions)."""
    rng = np.random.default_rng(0)
    ta = np.where(rng.random((K, N_CLAUSES)) < 0.08, N_STATES + 1, N_STATES)
    w = rng.integers(-20, 20, (M, N_CLAUSES))
    lits = rng.random((B, K)) < 0.85
    jcfg = JConfig(n_literals=K, n_clauses=N_CLAUSES, n_classes=M,
                   n_states=N_STATES)
    icfg = dict(variability=False, max_tile_cols=32)
    jsys = j_build_system(JParams(ta_state=jnp.asarray(ta, jnp.int32),
                                  weights=jnp.asarray(w, jnp.int32)), jcfg,
                          jax.random.key(0), JImpactConfig(**icfg))
    assert jsys.clause_g.shape[1] == 2
    d = {f: np.asarray(getattr(jsys, f)) for f in
         ("clause_g", "nonempty", "class_g", "clause_i", "class_i")}
    d.update(n_literals=K, n_clauses=N_CLAUSES, n_classes=M, cfg=icfg,
             program_energy_j=float(jsys.encode_stats["program_energy_j"]),
             erase_energy_j=float(jsys.encode_stats["erase_energy_j"]))
    tsys = system_from_arrays(d, device="cpu")
    cfg = CoTMConfig(n_literals=K, n_clauses=N_CLAUSES, n_classes=M,
                     n_states=N_STATES)
    params = params_from_arrays(ta, w, device="cpu")
    tl = torch.from_numpy(lits)
    labels = predict(params, tl, cfg)
    trained = common.Trained(cfg, params, tl, labels,
                             common.accuracy(predict(params, tl, cfg),
                                             labels))
    return jsys, tsys, trained, lits


@pytest.fixture(scope="module")
def table4_rows(table4_systems):
    _, tsys, trained, _ = table4_systems
    return {r.name: r for r in t4.main(device="cpu", trained=trained,
                                       system=tsys, n_report=B)}


@pytest.fixture(scope="module")
def reference_reports(table4_systems):
    jsys, _, _, lits = table4_systems
    return {m: jsys.compile(JSpec(metering=m)).infer_with_report(
        jnp.asarray(lits)) for m in ("staged", "fused")}


@pytest.fixture(scope="module")
def iris():
    """The reference's ``run_dataset("iris")`` at a small size on ideal
    devices (its ``build_system`` given ``variability=False``), with the
    parameters it trained captured -> (its result, the parameters)."""
    got, real = {}, r_t5.train_epochs

    def train(*a, **kw):
        got["params"] = real(*a, **kw)
        return got["params"]

    def ideal(params, cfg, key):
        return j_build_system(params, cfg, key,
                              JImpactConfig(variability=False))

    mp = pytest.MonkeyPatch()
    mp.setattr(r_t5, "train_epochs", train)
    mp.setattr(r_t5, "build_system", ideal)
    try:
        result = r_t5.run_dataset("iris", IRIS_TRAIN, IRIS_EPOCHS)
    finally:
        mp.undo()
    p = got["params"]
    return result, (np.asarray(p.ta_state), np.asarray(p.weights))


# -- (a) constants --------------------------------------------------------------

@pytest.mark.parametrize("ours, theirs", [
    (t4.PAPER, r_t4.PAPER), (t5.PAPER_ACC, r_t5.PAPER_ACC),
    (t6.COMPETITORS, r_t6.COMPETITORS), (t6.PAPER_OURS, r_t6.PAPER_OURS)],
    ids=["table4.PAPER", "table5.PAPER_ACC", "table6.COMPETITORS",
         "table6.PAPER_OURS"])
def test_paper_constants_equal_the_reference(ours, theirs):
    assert ours == theirs


def test_inline_anchors_equal_the_reference():
    """The anchors the reference writes inline in its rows."""
    src = (ROOT / "benchmarks" / "table4_energy.py").read_text()
    assert f"paper={t4.PAPER_TOPS_PER_W}" in src
    assert f"paper={t4.PAPER_MNIST_ACC}" in src


# -- (b) Table 4 ----------------------------------------------------------------

def _reference_cells() -> dict[str, float]:
    """The reference script's own expressions (``table4_energy.py:45-61``)."""
    rc, v, t = r_t4.read_current, r_t4.V_READ, r_t4.T_READ
    i_col = float(rc(jnp.full((2048, 1), 2.5e-6)).sum() * 1.0)
    return {
        "table4/program_nJ_per_pulse": r_t4.energy_mod.E_PROGRAM_PULSE * 1e9,
        "table4/erase_pJ_per_pulse": r_t4.energy_mod.E_ERASE_PULSE * 1e12,
        "table4/read_HCS_pJ": float(v * rc(jnp.asarray(2.5e-6)) * t) * 1e12,
        "table4/read_LCS_pJ": float(v * rc(jnp.asarray(1e-9)) * t) * 1e12,
        "table4/energy_per_op_pJ_worstcase": i_col * v * t * 1e12}


@pytest.mark.parametrize("name", list(_reference_cells()))
def test_table4_cell_energies(table4_rows, name):
    np.testing.assert_allclose(table4_rows[name].values["ours"],
                               _reference_cells()[name], rtol=RTOL_CELL)


@pytest.mark.parametrize("metering, suffix",
                         [("staged", ""), ("fused", "_fused")])
def test_table4_report_rows(table4_rows, reference_reports, metering,
                            suffix):
    rep = reference_reports[metering].report
    n = rep.datapoints
    assert n == B
    for row, want in (
            (f"clause_pJ_per_datapoint{suffix}",
             rep.clause_energy_j / n * 1e12),
            (f"class_pJ_per_datapoint{suffix}", rep.class_energy_j / n * 1e12),
            (f"tops_per_w{suffix}", rep.tops_per_w)):
        np.testing.assert_allclose(table4_rows[f"table4/{row}"]
                                   .values["ours"], want, rtol=RTOL_REPORT)
    if metering == "staged":
        assert table4_rows["table4/gops"].values["ours"] == rep.gops


@pytest.mark.parametrize("metering", ["staged", "fused"])
def test_table4_predictions_equal(table4_systems, reference_reports,
                                  metering):
    """The sessions ``table4_energy.main`` served (``compile`` caches them
    by spec) predict what the reference's do."""
    _, tsys, trained, lits = table4_systems
    got = tsys.compile(RuntimeSpec(metering=metering, device="cpu")
                       ).infer_with_report(lits).predictions
    want = np.asarray(reference_reports[metering].predictions)
    np.testing.assert_array_equal(got.numpy(), want)


def test_table4_areas_and_accuracy(table4_systems, table4_rows,
                                   reference_reports):
    jsys, _, trained, _ = table4_systems
    areas = jsys.area_mm2()
    assert table4_rows["table4/area_clause_mm2"].values["ours"] == \
        areas["clause"]
    assert table4_rows["table4/area_class_mm2"].values["ours"] == \
        areas["class_"]
    want_hw = float((np.asarray(reference_reports["staged"].predictions)
                     == trained.labels.numpy()).mean())
    acc = table4_rows["table4/accuracy"].values
    assert acc["hw"] == want_hw and acc["sw"] == trained.sw_acc
    assert [r for r in table4_rows] == [
        n for n in _emitted_names(r_t4) if n.startswith("table4/")]


def test_table4_gate_raises(table4_systems, monkeypatch):
    """The fused-vs-staged gate raises ``GateError`` (not a bare assert)
    when the meters part."""
    _, tsys, trained, _ = table4_systems
    real = t4.metered

    def skewed(system, spec, lits):
        res, dt = real(system, spec, lits)
        if spec.metering == "fused":
            res.report.class_energy_j *= 1.0 + 2 * t4.RTOL_METERS
        return res, dt

    monkeypatch.setattr(t4, "metered", skewed)
    with pytest.raises(common.GateError, match="class_energy_j"):
        t4.main(device="cpu", trained=trained, system=tsys, n_report=B)


# -- (c) Table 6 ----------------------------------------------------------------

def test_table6_ratios(table4_systems, reference_reports):
    _, tsys, trained, _ = table4_systems
    rows = {r.name: r for r in t6.main(device="cpu", trained=trained,
                                       system=tsys, n_report=B)}
    rep = reference_reports["staged"].report
    np.testing.assert_allclose(rows["table6/ours_tops_per_w"].values["ours"],
                               rep.tops_per_w, rtol=RTOL_REPORT)
    np.testing.assert_allclose(
        rows["table6/ours_tops_per_mm2"].values["ours"], rep.tops_per_mm2,
        rtol=RTOL_REPORT)
    for name, (tw, tmm, _, _) in r_t6.COMPETITORS.items():
        v = rows[f"table6/vs_{name}"].values
        np.testing.assert_allclose(v["ratio_tops_w"], rep.tops_per_w / tw,
                                   rtol=RTOL_REPORT)
        if tmm:
            np.testing.assert_allclose(v["ratio_tops_mm2"],
                                       rep.tops_per_mm2 / tmm,
                                       rtol=RTOL_REPORT)
        else:
            assert "ratio_tops_mm2" not in v
    assert list(rows) == [n.replace("{name}", c) for n in
                          _emitted_names(r_t6) for c in
                          (r_t6.COMPETITORS if "{name}" in n else [""])]


# -- (d) Fig. 13 ------------------------------------------------------------------

def _reference_fig13(ta, w, lits, labels, n_states):
    """The reference script's body (``fig13_tuning_sweep.py:26-78``) with
    the functions it imports, on ideal devices."""
    include = j_include_mask(jnp.asarray(ta), n_states)
    clause_tile, _ = r_f13.encode_clause_tile(include, jax.random.key(0),
                                              variability=False)
    w_uni, _ = r_f13.to_unipolar(jnp.asarray(w))
    w_t = w_uni.T
    w_max = int(jnp.max(w_uni))
    target = np.asarray(r_f13.weight_targets(w_t, w_max))
    seg = (r_f13.G_RANGE_HI - r_f13.G_RANGE_LO) / max(w_max, 1)
    clauses = clause_tile.clauses(jnp.asarray(lits[:512]))

    def accuracy(class_g):
        scores = clauses.astype(jnp.float32) @ jy.read_current(
            jnp.asarray(class_g))
        return float((jnp.argmax(scores, -1) == labels[:512]).mean())

    def encode(**kw):
        return r_f13.encode_class_tile(w_t, jax.random.key(1),
                                       variability=False, **kw)

    out = {}
    for budget in f13.BUDGETS:
        tile, _ = encode(finetune=False, max_pulses=budget)
        out[f"fig13/pretune_budget_{budget}"] = dict(
            acc=accuracy(tile.g),
            cost=float((np.abs(np.asarray(tile.g) - target)
                        > 20 * seg).mean()))
    tile, st = encode(finetune=True, max_pulses=96)
    out["fig13/finetuned"] = dict(
        acc=accuracy(tile.g),
        cost_5seg=float((np.abs(np.asarray(tile.g) - target)
                         > 5 * seg).mean()),
        mean_finetune_pulses=float((st["finetune_prog"]
                                    + st["finetune_erase"]).mean()))
    tile, st = encode(adaptive=True, max_pulses=96)
    out["fig13/adaptive_controller_beyond_paper"] = dict(
        acc=accuracy(tile.g),
        mean_pulses=float((st["pretune_prog"] + st["pretune_erase"]).mean()),
        mean_err_segments=float(np.abs(np.asarray(tile.g) - target).mean()
                                / seg))
    return out


@pytest.mark.parametrize("weights", ["iris", "random"])
def test_fig13_on_ideal_devices(request, weights):
    if weights == "iris":
        _, (ta, w) = request.getfixturevalue("iris")
        xt, yt, spec = t_synthetic.table5_dataset("iris", 400, seed=7)
        lits = np.concatenate([xt, 1 - xt], -1).astype(bool)
        cfg = CoTMConfig(n_literals=spec["literals"],
                         n_clauses=spec["clauses"],
                         n_classes=spec["classes"], n_states=128,
                         threshold=32, specificity=5.0)
        labels = torch.from_numpy(yt).long()
    else:
        _, _, t, lits = request.getfixturevalue("table4_systems")
        cfg, labels = t.cfg, t.labels
        ta, w = t.params.ta_state.numpy(), t.params.weights.numpy()
    params = params_from_arrays(ta, w, device="cpu")
    tl = torch.from_numpy(lits)
    trained = common.Trained(cfg, params, tl, labels, common.accuracy(
        predict(params, tl, cfg), labels))
    rows = f13.main(device="cpu", trained=trained, variability=False)
    want = _reference_fig13(ta, w, lits, labels.numpy(), cfg.n_states)
    assert [r.name for r in rows] == list(want)
    for r in rows:
        for k, v in want[r.name].items():
            if k == "mean_err_segments":
                np.testing.assert_allclose(r.values[k], v,
                                           rtol=RTOL_SEGMENTS)
            elif k != "cost" and k != "cost_5seg":
                np.testing.assert_allclose(r.values[k], v,
                                           rtol=RTOL_F32_MEAN)
            else:
                assert r.values[k] == v, (r.name, k)


# -- (e), (f) Figs. 7-8 ---------------------------------------------------------

def _port_var(jvar) -> DeviceVariation:
    return DeviceVariation(*(torch.from_numpy(np.array(getattr(jvar, f)))
                             for f in ("tau_prog", "tau_erase", "g_floor",
                                       "g_ceil")))


@pytest.fixture()
def noise_off(monkeypatch):
    """The reference script's loops with the pulse noise off."""
    monkeypatch.setattr(r_f78, "pulse_until",
                        functools.partial(jy.pulse_until, c2c=False))


def test_c2c_without_noise(noise_off):
    want = r_f78.c2c(C2C_CYCLES_IDEAL)
    got = f78.c2c(C2C_CYCLES_IDEAL, device="cpu", c2c=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL_TRAJECTORY)


def test_d2d_without_noise(noise_off):
    n = 50
    want = r_f78.d2d(n)
    var = _port_var(jy.DeviceVariation.sample(jax.random.key(3), (n,)))
    got = f78.d2d(n, device="cpu", c2c=False, var=var)
    for i in (1, 3):                                   # pulse counts
        np.testing.assert_array_equal(got[i], want[i])
    for i in (0, 2):                                   # conductances
        np.testing.assert_allclose(got[i], want[i], rtol=RTOL_TRAJECTORY)


def _within_se(got: np.ndarray, want: np.ndarray, what: str) -> None:
    se = np.sqrt(got.var(ddof=1) / got.size + want.var(ddof=1) / want.size)
    assert abs(got.mean() - want.mean()) <= N_SE * se, (
        what, got.mean(), want.mean(), se)


def test_c2c_and_d2d_statistics_with_noise():
    for what, g, w in zip(("LCS", "HCS"), f78.c2c(20, device="cpu"),
                          r_f78.c2c(20)):
        _within_se(g.astype(np.float64), w.astype(np.float64), f"c2c {what}")
    got, want = f78.d2d(50, device="cpu"), r_f78.d2d(50)
    for what, g, w in zip(("LCS", "program pulses", "HCS", "erase pulses"),
                          got, want):
        _within_se(g.astype(np.float64), w.astype(np.float64), f"d2d {what}")


# -- (g) Table 5 ----------------------------------------------------------------

@pytest.mark.parametrize("name", list(t_synthetic.TABLE5))
def test_table5_dataset_equal(name):
    assert t_synthetic.TABLE5[name] == j_synthetic.TABLE5[name]
    for n, seed in ((64, 0), (16, 7)):
        got, want = (t_synthetic.table5_dataset(name, n, seed=seed),
                     j_synthetic.table5_dataset(name, n, seed=seed))
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)


def test_table5_iris_on_ideal_devices(iris):
    (_, sw, hw, spec), (ta, w) = iris
    systems = {}
    us, t_sw, t_hw, t_spec = t5.run_dataset(
        "iris", IRIS_TRAIN, IRIS_EPOCHS, device="cpu",
        params=params_from_arrays(ta, w, device="cpu"),
        impact_cfg=IMPACTConfig(variability=False), systems=systems)
    assert (us, t_spec) == (0.0, spec)
    np.testing.assert_allclose([t_sw, t_hw], [sw, hw], rtol=RTOL_F32_MEAN)
    assert systems["iris"].n_literals == spec["literals"]


def test_table5_trains_on_the_cpu():
    """The section end to end at a tiny size: one row a name, accuracies
    in [0, 1], the training wall measured."""
    rows = t5.main(device="cpu", names=("iris", "emg"), n_train=100,
                   epochs=1)
    assert [r.name for r in rows] == ["table5/iris", "table5/emg"]
    for r in rows:
        assert r.us_per_call > 0
        assert 0.0 <= r.values["sw"] <= 1.0 and 0.0 <= r.values["hw"] <= 1.0


# -- common ---------------------------------------------------------------------

def test_trained_mnist_cotm_cache(tmp_path, monkeypatch):
    """Trains at the paper's config, writes the cache, reads it back; given
    ``params`` it neither trains nor caches."""
    monkeypatch.setattr(common, "ARTIFACTS", tmp_path / "artifacts")
    kw = dict(n_clauses=8, epochs=1, n_train=64, tag="t", device="cpu")
    first = common.trained_mnist_cotm(**kw)
    cfg = first.cfg
    assert (cfg.n_literals, cfg.n_classes, cfg.n_states, cfg.threshold,
            cfg.specificity) == (1568, 10, 128, 96, 8.0)
    assert first.lits.shape == (1000, 1568)
    path = tmp_path / "artifacts" / "torch_cotm_t_8c_1e.pkl"
    assert path.exists()
    again = common.trained_mnist_cotm(**kw)
    assert torch.equal(again.params.ta_state, first.params.ta_state)
    assert torch.equal(again.params.weights, first.params.weights)
    assert again.sw_acc == first.sw_acc
    path.unlink()
    given = common.trained_mnist_cotm(**kw, params=first.params)
    assert torch.equal(given.params.weights, first.params.weights)
    assert not path.exists()


# -- (h) the command line -------------------------------------------------------

def _emitted_names(module) -> list[str]:
    """The row names of every ``emit`` call in a reference script's
    ``main``, in source order (f-strings keep their braces)."""
    tree = ast.parse(pathlib.Path(module.__file__).read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    names = []
    for node in ast.walk(main):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None)
                == "emit"):
            arg = node.args[0]
            names.append((node.lineno, node.col_offset, (
                arg.value if isinstance(arg, ast.Constant) else
                "".join(v.value if isinstance(v, ast.Constant)
                        else "{" + ast.unparse(v.value) + "}"
                        for v in arg.values))))
    return [name for _, _, name in sorted(names)]


def test_cli_fig7_8_rows():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.paper", "--device", "cpu",
         "--only", "fig7_8"], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True).stdout.splitlines()
    assert out[:2] == ["# device: cpu", "name,us_per_call,derived"]
    assert [line.split(",")[0] for line in out[2:]] == \
        _emitted_names(r_f78)


def test_cli_section_error_exits_1(monkeypatch, capsys):
    def boom(**kw):
        raise ValueError("broken section")

    monkeypatch.setitem(cli.SECTIONS, "table6", boom)
    monkeypatch.setitem(cli.SECTIONS, "fig13", lambda **kw: [])
    assert cli.main(["--device", "cpu", "--only", "table6,fig13"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "table6/ERROR,0.0,ValueError:broken section"
    monkeypatch.setitem(cli.SECTIONS, "table6", lambda **kw: [])
    assert cli.main(["--device", "cpu", "--only", "table6,fig13"]) == 0


def test_cli_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setitem(cli.SECTIONS, "fig7_8", lambda **kw: [])
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["--only", "fig7_8"])

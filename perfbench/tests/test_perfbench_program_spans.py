"""The readers of the program's own spans and counters
(``repro_torch.tracing.totals()``): the value each reads from a table,
None from a program without the module or with an empty table (as on a
program that has no such span), and no program name that the benchmark's
own spans use."""
import ast
import sys

import pytest

from perfbench import harness
from perfbench.families import cotm

# 4 MNIST batches and 5 bills: per batch 25,706,496 B of int8 literals and
# bool valid in, 262,144 B of predictions and two energy lanes out.
TABLE = {
    "runtime.infer_step": dict(count=4, seconds=4e-3, self_seconds=8e-4,
                               parent=None),
    "graphs.copy_in": dict(count=4, seconds=1.2e-3, self_seconds=1.2e-3,
                           parent="runtime.infer_step"),
    "graphs.replay": dict(count=4, seconds=6e-4, self_seconds=6e-4,
                          parent="runtime.infer_step"),
    "graphs.clone": dict(count=4, seconds=4e-4, self_seconds=4e-4,
                         parent="runtime.infer_step"),
    "pipeline.step_report": dict(count=5, seconds=1e-3, self_seconds=1e-3,
                                 parent=None),
    "graphs.copy_in_bytes": dict(count=4 * 25_706_496, seconds=0.0,
                                 self_seconds=0.0, parent="graphs.copy_in"),
    "graphs.clone_bytes": dict(count=4 * 262_144, seconds=0.0,
                               self_seconds=0.0, parent="runtime.infer_step"),
    "graphs.captures": dict(count=1, seconds=0.0, self_seconds=0.0,
                            parent=None),
}
EXPECTED = dict(infer_step_self_ms=0.2, copy_in_ms=0.3, replay_ms=0.15,
                clone_ms=0.1, step_report_ms=0.2,
                graph_mb_per_batch=25.96864, graph_captures=1.0)
RUN = harness.Run(1.0, 1.0, 1, 1, [1.0], {}, 0, 1.0, 1.0)


def program_names() -> set[str]:
    """Every literal name the program passes to ``tracing.span`` or
    ``tracing.add``."""
    names = set()
    for path in (harness.ROOT / "src" / "repro_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "tracing"
                    and node.func.attr in ("span", "add") and node.args
                    and isinstance(node.args[0], ast.Constant)):
                names.add(node.args[0].value)
    return names


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reads_the_table(monkeypatch, metric):
    from repro_torch import tracing
    monkeypatch.setattr(tracing, "totals", lambda: TABLE)
    assert harness.reader(metric)(RUN) == pytest.approx(EXPECTED[metric],
                                                        rel=1e-12)


GRAPH = ("copy_in_ms", "replay_ms", "clone_ms", "graph_mb_per_batch")


@pytest.mark.parametrize("metric", GRAPH)
def test_graph_metrics_count_every_entrys_batches(monkeypatch, metric):
    # As many batches again through predict: each replays one graph.
    from repro_torch import tracing
    table = {name: dict(row) for name, row in TABLE.items()}
    table["runtime.predict"] = dict(count=4, seconds=4e-3,
                                    self_seconds=8e-4, parent=None)
    for name in ("graphs.copy_in", "graphs.replay", "graphs.clone",
                 "graphs.copy_in_bytes", "graphs.clone_bytes"):
        for key in ("count", "seconds", "self_seconds"):
            table[name][key] *= 2
    monkeypatch.setattr(tracing, "totals", lambda: table)
    assert harness.reader(metric)(RUN) == pytest.approx(EXPECTED[metric],
                                                        rel=1e-12)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_an_empty_table_reads_nothing(monkeypatch, metric):
    from repro_torch import tracing
    monkeypatch.setattr(tracing, "totals", lambda: {})
    assert harness.reader(metric)(RUN) is None


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_a_program_without_the_module_reads_nothing(monkeypatch, metric):
    import repro_torch
    import repro_torch.tracing  # noqa: F401
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert harness.reader(metric)(RUN) is None


def test_program_names_are_not_the_benchmarks():
    names = program_names()
    read = {n for n in TABLE}
    assert read <= names
    assert not names & set(cotm.SPANS)

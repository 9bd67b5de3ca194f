"""Nothing under perfbench/ imports JAX or the JAX package, judged by whole
top-level name (``repro_torch`` begins with ``repro``), and the
reference imports nothing of the program."""
import ast
import json
import subprocess
import sys

import pytest

from perfbench import harness

FILES = sorted(harness.HERE.rglob("*.py"))


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def top(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_no_jax_import(path):
    assert not {top(m) for m in imported(path)} & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "references").glob("*.py"):
        assert "repro_torch" not in {top(m) for m in imported(path)}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.setitem(sys.modules, "reproduce.x", object())
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    """A whole run of a tiny cell in a fresh process leaves no JAX module
    behind."""
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = {[str(harness.ROOT), str(harness.ROOT / 'src')]!r}\n"
        "from perfbench import harness\n"
        "from perfbench.tests._tiny import tiny\n"
        "r = harness.run(tiny('mnist.bulk-fused'), 3, 0.05, False, 'cpu',\n"
        "                time.perf_counter())\n"
        "print(json.dumps(dict(correct=r['correct'], mods=sorted(\n"
        "    {m.split('.')[0] for m in sys.modules}))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"]
    assert "repro_torch" in r["mods"]
    assert not set(r["mods"]) & set(harness.FORBIDDEN)


def _command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "mnist.bulk-fused",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_command_without_the_program_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and perfbench/."""
    import shutil
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_command_without_a_card_prints_no_result(monkeypatch):
    """Here, where ``torch.cuda.is_available()`` is false (hidden where a
    card is at hand)."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    out = _command(harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""

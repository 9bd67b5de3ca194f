"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX reference package ``repro``,
importing the port loads neither, and an entry point that was not given
``device="cpu"`` raises when there is no CUDA device instead of falling
back to the CPU."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert, repro_torch.core, "
        "repro_torch.data.synthetic, repro_torch.impact, repro_torch.kernels,"
        " repro_torch.serve, repro_torch.train, repro_torch.quickstart, "
        "repro_torch.analysis, repro_torch.impact.costmodel, "
        "repro_torch.kernels.work, repro_torch.kernels.ops, "
        "repro_torch.launch, repro_torch.sharding, "
        "repro_torch.sharding.crossbar, repro_torch.crossbar_scaling, "
        "repro_torch.models, repro_torch.configs, repro_torch.serve_lm, "
        "repro_torch.train_lm, repro_torch.launch.specs, "
        "repro_torch.sharding.layout, repro_torch.train.step, "
        "repro_torch.launch.census, repro_torch.launch.dryrun\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    from repro_torch import resolve_device
    from repro_torch.convert import params_from_arrays, system_from_arrays
    from repro_torch.core.cotm import CoTMConfig
    from repro_torch.impact import IMPACTConfig, RuntimeSpec, build_system

    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        params_from_arrays(np.zeros((4, 2)), np.zeros((3, 2)))
    params = params_from_arrays(np.full((4, 2), 9), np.ones((3, 2)),
                                device="cpu")
    cfg = CoTMConfig(4, 2, 3, n_states=8)
    ideal = IMPACTConfig(variability=False, finetune=False)
    with pytest.raises(RuntimeError):
        build_system(params, cfg, None, ideal)
    system = build_system(params, cfg, None, ideal, device="cpu")
    with pytest.raises(RuntimeError):
        system.compile()
    with pytest.raises(RuntimeError):
        system.compile(RuntimeSpec(backend="torch"))
    assert system.compile(RuntimeSpec(device="cpu")).predict(
        np.ones((2, 4), bool)).predictions.shape == (2,)
    d = {f: getattr(system, f).numpy() for f in
         ("clause_g", "nonempty", "class_g", "clause_i", "class_i")}
    d.update(n_literals=4, n_clauses=2, n_classes=3, program_energy_j=0.0,
             erase_energy_j=0.0)
    with pytest.raises(RuntimeError):
        system_from_arrays(d)


def test_lm_entry_points_raise_without_cuda(no_cuda):
    """The LM slice's entry points: ``build``, ``lm_params_from_arrays``
    and ``TMHead.init`` default to ``cuda`` and raise here; each runs when
    given ``device="cpu"`` (``build`` also on ``"meta"``)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_arrays, lm_params_from_arrays
    from repro_torch.models import TMHead, TMHeadConfig, build

    cfg = get_config("llama3-8b").smoke()
    with pytest.raises(RuntimeError, match="is_available"):
        build(cfg)
    assert build(get_config("llama3-8b"), device="meta").n_params() > 7e9
    model = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tree = lm_arrays(model)
    with pytest.raises(RuntimeError, match="is_available"):
        lm_params_from_arrays(cfg, tree)
    assert lm_params_from_arrays(cfg, tree, device="cpu").device.type == \
        "cpu"
    head = TMHead(TMHeadConfig(), d_features=8)
    with pytest.raises(RuntimeError, match="is_available"):
        head.init()
    assert head.init(device="cpu").ta_state.shape == (16, 500)


def test_lm_training_entry_points_raise_without_cuda(no_cuda, tmp_path,
                                                    monkeypatch):
    """The LM training slice's entry points: ``make_train_step``,
    ``TrainLoop``, ``train_state_from_arrays`` and ``train_lm`` default to
    ``cuda`` and raise here; each runs when given ``device="cpu"``."""
    from repro_torch import train_lm
    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_from_arrays
    from repro_torch.models import build
    from repro_torch.train import (AdamWConfig, RuntimeConfig, TrainLoop,
                                   init_state, make_train_step)

    model = build(get_config("llama3-8b").smoke(), device="cpu").init(
        torch.Generator().manual_seed(0))
    opt = AdamWConfig()
    state = init_state(model.tree(), opt)
    with pytest.raises(RuntimeError, match="is_available"):
        make_train_step(model, opt)
    step = make_train_step(model, opt, device="cpu")
    rt = RuntimeConfig(ckpt_dir=str(tmp_path / "loop"), max_steps=1)
    batch = {"tokens": np.zeros((1, 2, 8), np.int32)}
    with pytest.raises(RuntimeError, match="is_available"):
        TrainLoop(step, state, iter([batch]), rt)
    TrainLoop(step, state, iter([batch]), rt, device="cpu").run()
    arrays = dict(step=np.int32(0), params=model.tree(), m=model.tree(),
                  v=model.tree())
    with pytest.raises(RuntimeError, match="is_available"):
        train_state_from_arrays(arrays)
    assert train_state_from_arrays(arrays, device="cpu").step.dtype == \
        torch.int32
    with pytest.raises(RuntimeError, match="is_available"):
        train_lm.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "a")])
    monkeypatch.setattr(train_lm, "hundred_m_variant",
                        lambda cfg: cfg.smoke())     # megabyte checkpoints
    with pytest.raises(RuntimeError, match="is_available"):
        train_lm.train("musicgen-large", steps=1, ckpt_dir=str(tmp_path))
    out = train_lm.train("musicgen-large", steps=1, batch=2, seq=8,
                         ckpt_dir=str(tmp_path / "b"), device="cpu",
                         log=lambda *a: None)
    assert len(out["losses"]) == 1


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    """Alone in a directory (no ``src/`` beside it), or on a machine
    without a card, ``chip_smoke.py`` exits non-zero and prints no result
    line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

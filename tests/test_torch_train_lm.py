"""The port of ``examples/train_lm.py`` (``repro_torch.train_lm``) and of
the training specs (``repro_torch.launch.specs``), on the CPU:
``synth_tokens`` bit for bit against the reference's, the batch specs
and the ~100M variants against the reference's, and the driver at a tiny
size: the loss falls, a run resumes, and a run that failed resumes onto
the losses of one that did not."""
import dataclasses
import json

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro_torch import configs as tconfigs
from repro_torch import train_lm
from repro_torch.launch import specs as tspecs
from repro_torch.train import SimulatedFailure

from _torch_lm_fields import reference_fields

ARCH = "musicgen-large"


@pytest.fixture()
def smoke_variant(monkeypatch):
    """The driver on the smoke configs instead of its ~100M variants:
    the same code, checkpoints of a megabyte instead of hundreds (the
    variants themselves are held to the reference's below, and run on
    the card in ``chip_smoke.py`` phase 14 (d))."""
    monkeypatch.setattr(train_lm, "hundred_m_variant", lambda cfg: cfg.smoke())


@pytest.mark.parametrize("name,seed", [("llama3-8b", 0), ("musicgen-large", 3),
                                       ("rwkv6-7b", 7)])
def test_synth_tokens_bitwise(name, seed):
    for smoke in (False, True):
        jc, tc = jconfigs.get_config(name), tconfigs.get_config(name)
        if smoke:
            jc, tc = jc.smoke(), tc.smoke()
        want = np.asarray(jspecs.synth_tokens(jc, 5, 40, seed=seed))
        got = tspecs.synth_tokens(tc, 5, 40, seed=seed)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", jconfigs.ARCH_IDS)
def test_train_batch_specs(name):
    shape = jconfigs.SHAPES["train_4k"]
    want = jspecs.train_batch_specs(jconfigs.get_config(name), shape)
    got = tspecs.train_batch_specs(tconfigs.get_config(name),
                                   tconfigs.SHAPES["train_4k"])
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k


@pytest.mark.parametrize("name", jconfigs.ARCH_IDS)
def test_hundred_m_variant(name):
    """The reference example's variant, but for qwen2-vl's M-RoPE
    sections, split over its head of 64 (module doc)."""
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parent.parent / "examples"
            / "train_lm.py")
    spec = importlib.util.spec_from_file_location("ref_train_lm", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    want = dataclasses.asdict(ref.hundred_m_variant(
        jconfigs.get_config(name)))
    got = reference_fields(train_lm.hundred_m_variant(
        tconfigs.get_config(name)))
    if name == "qwen2-vl-2b":
        assert got.pop("mrope_sections") == (8, 12, 12)
        assert want.pop("mrope_sections") == (16, 24, 24)
    assert got == want


def test_main_reduces_loss_and_resumes(tmp_path, capsys, smoke_variant):
    args = ["--arch", ARCH, "--device", "cpu", "--batch", "2", "--seq",
            "32", "--lr", "3e-3", "--ckpt-dir", str(tmp_path)]
    train_lm.main(args + ["--steps", "20"])
    out = capsys.readouterr().out
    assert "OK: loss decreased" in out
    assert "auto-resumed" not in out
    train_lm.main(args + ["--steps", "20"])      # nothing left to run
    out = capsys.readouterr().out
    assert "auto-resumed from step 20" in out and "loss:" not in out


def test_failed_run_resumes_onto_the_same_losses(tmp_path, smoke_variant):
    """Fail before step 7 (checkpoints every 3 steps), resume: steps 6-11
    give the uninterrupted run's losses bit for bit, and the heartbeat
    names the last step."""
    kw = dict(steps=12, batch=2, seq=32, lr=3e-3, save_every=3,
              device="cpu", log=lambda *a: None)
    ref = train_lm.train(ARCH, ckpt_dir=str(tmp_path / "ref"), **kw)
    with pytest.raises(SimulatedFailure):
        train_lm.train(ARCH, ckpt_dir=str(tmp_path / "ft"), fail_at_step=7,
                       **kw)
    resumed = train_lm.train(ARCH, ckpt_dir=str(tmp_path / "ft"), **kw)
    assert resumed["start"] == 6
    assert resumed["losses"] == ref["losses"][6:]
    hb = json.loads((tmp_path / "ft" / "HEARTBEAT").read_text())
    assert hb["step"] == 10


def test_qwen2_vl_trains_with_mrope_positions(tmp_path, smoke_variant):
    out = train_lm.train("qwen2-vl-2b", steps=2, batch=2, seq=16, accum=2,
                         ckpt_dir=str(tmp_path), device="cpu",
                         log=lambda *a: None)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))


def test_jax_is_not_needed_for_tokens():
    """``synth_tokens`` returns numpy, not a jax array."""
    toks = tspecs.synth_tokens(tconfigs.get_config("llama3-8b"), 2, 8)
    assert isinstance(toks, np.ndarray) and not isinstance(toks, jax.Array)

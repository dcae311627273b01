"""The eight scripts of ``examples_torch/`` (the JAX package's
``examples/`` on the port's API) run through their ``main(argv)`` with
``--device cpu`` at their smallest sizes, each to its own end (the
training example asserts its loss fell)."""

import pathlib
import sys

import pytest
import torch

torch.set_num_threads(1)

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples_torch"
#: script -> the smallest arguments its run makes sense at
RUNS = {
    "quickstart": ["--grid", "8"],
    "registration_3d": ["--grid", "8", "--max-newton", "2"],
    "multires_registration": ["--grid", "8", "--max-newton", "2"],
    "multimodal_registration": ["--grid", "8", "--max-newton", "2", "--measures", "ssd,ncc"],
    "ensemble_registration": ["--grid", "8", "--batch", "2", "--newton-steps", "2"],
    "serve_registration": ["--grid", "8", "--subjects", "1", "--max-newton", "2"],
    "serve_lm": ["--requests", "2", "--prompt", "8", "--gen", "2"],
    "train_lm": ["--steps", "3", "--batch", "2", "--seq", "16"],
}


@pytest.fixture(scope="module", autouse=True)
def on_path():
    sys.path.insert(0, str(EXAMPLES))
    yield
    sys.path.remove(str(EXAMPLES))


def test_every_example_has_a_run():
    assert sorted(RUNS) == sorted(p.stem for p in EXAMPLES.glob("*.py")
                                  if not p.stem.startswith("_"))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu(name, capsys):
    module = __import__(name)
    out = module.main(RUNS[name] + ["--device", "cpu"])
    assert out is not None
    assert capsys.readouterr().out.strip()


def test_ensemble_example_steps_every_pair(capsys):
    stats = __import__("ensemble_registration").main(
        ["--grid", "8", "--batch", "2", "--newton-steps", "1", "--device", "cpu"])
    assert stats.v_new.shape == (2, 3, 8, 8, 8) and torch.isfinite(stats.v_new).all()
    assert "GN step 0" in capsys.readouterr().out


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        __import__("quickstart").main(["--grid", "8"])

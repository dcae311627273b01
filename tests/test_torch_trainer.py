"""The port's fault-tolerant ``Trainer`` (``repro_torch.train.trainer``) and
training launcher, on the smollm-135m smoke config on the CPU.

* The three trainer claims of ``tests/test_checkpoint_trainer.py`` (whose
  JAX trainer tests are red under JAX 0.9, ROADMAP C), held on the port
  alone: the loss decreases, a restart resumes from step 3 to 6, restored
  values are equal to those saved (every leaf, bit for bit).
* A SIGTERM sent during a step checkpoints at the end of that step and stops.
* A step that sleeps once is counted as a straggler, and only that one.
* Across packages: a JAX ``TrainState`` written by ``repro.checkpoint``
  restores into the port's ``Trainer``, and a port checkpoint into JAX's
  ``abstract_train_state``, bit for bit.
* ``launch.train.main`` for one arch of each family, and its refusals.
"""

import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild
from repro.optim import adamw as JO
from repro.train import steps as jsteps
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.configs import ARCHS
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig, leaves
from repro_torch.train import steps as tsteps
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)


def _mk_trainer(tmp_path, steps=6, ckpt_every=3):
    cfg = ARCHS["smollm-135m"].smoke()
    tcfg = TrainerConfig(total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(tmp_path),
                         log_every=1, opt=AdamWConfig(lr=1e-3, total_steps=steps,
                                                      warmup_steps=1))
    return cfg, Trainer(build_model(cfg, "cpu"), None, tcfg)


def _batches(cfg, seq=32, bs=2):
    return launch_train.token_batches(build_model(cfg, "cpu"), seq, bs, seed=1)


def _bits(t):
    return t.detach().contiguous().view(-1).view(torch.uint8).numpy().tobytes()


def _assert_states_equal(a, b):
    la, lb = leaves([a.params, a.opt]), leaves([b.params, b.opt])
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert _bits(x) == _bits(y)


def test_trainer_loss_decreases(tmp_path):
    cfg, trainer = _mk_trainer(tmp_path, steps=8, ckpt_every=3)
    trainer.run(_batches(cfg), prefetch=False)
    losses = [m["loss"] for m in trainer.metrics_log]
    assert [m["step"] for m in trainer.metrics_log] == list(range(1, 9))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(m["grad_norm"]) and m["step_time_s"] > 0
               for m in trainer.metrics_log)
    assert trainer.ckpt.last_path is not None and latest_step(str(tmp_path)) == 6


def test_trainer_restart_resumes_from_checkpoint(tmp_path):
    cfg, trainer = _mk_trainer(tmp_path, steps=3)
    trainer.run(_batches(cfg), torch.Generator().manual_seed(0))
    assert latest_step(str(tmp_path)) == 3
    _, trainer2 = _mk_trainer(tmp_path, steps=6)
    trainer2.init_or_restore()
    assert trainer2.start_step == 3
    state = trainer2.run(_batches(cfg))
    assert int(state.opt["step"]) == 6
    assert [m["step"] for m in trainer2.metrics_log] == [4, 5, 6]


def test_trainer_restore_identical_values(tmp_path):
    cfg, trainer = _mk_trainer(tmp_path, steps=3)
    state = trainer.run(_batches(cfg), prefetch=False)
    restored = restore_checkpoint(str(tmp_path), tsteps.abstract_train_state(trainer.model),
                                  device="cpu")
    assert isinstance(restored, tsteps.TrainState)
    _assert_states_equal(restored, state)


def test_sigterm_checkpoints_at_the_end_of_the_step(tmp_path):
    cfg, trainer = _mk_trainer(tmp_path, steps=6, ckpt_every=100)
    step_fn = trainer.step_fn
    calls = []

    def step(state, batch):
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step_fn(state, batch)

    trainer.step_fn = step
    before = signal.getsignal(signal.SIGTERM)
    state = trainer.run(_batches(cfg), prefetch=False)
    assert len(calls) == 2 and int(state.opt["step"]) == 2
    assert latest_step(str(tmp_path)) == 2
    assert signal.getsignal(signal.SIGTERM) == before
    restored = restore_checkpoint(str(tmp_path), tsteps.abstract_train_state(trainer.model),
                                  device="cpu")
    _assert_states_equal(restored, state)


def test_a_step_that_sleeps_once_is_a_straggler(tmp_path):
    """Every step sleeps 0.3 s, which dominates a smoke step; the fifth
    sleeps 2 s more, over straggler_factor (1.5) x the EMA."""
    cfg, trainer = _mk_trainer(tmp_path, steps=6, ckpt_every=100)
    step_fn = trainer.step_fn
    calls = []

    def step(state, batch):
        calls.append(1)
        time.sleep(0.3 + (2.0 if len(calls) == 5 else 0.0))
        return step_fn(state, batch)

    trainer.step_fn = step
    trainer.run(_batches(cfg), prefetch=False)
    assert trainer.straggler_steps == 1
    assert trainer.metrics_log[4]["step_time_s"] > 2.0


def _jax_pair():
    cfg = JARCHS["smollm-135m"].smoke()
    jm = jbuild(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    return jm, jsteps.TrainState(params, JO.adamw_init(params))


def _jax_bits(x):
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def test_jax_train_state_restores_into_the_port_trainer(tmp_path):
    jm, jstate = _jax_pair()
    rng = np.random.default_rng(0)
    opt = dict(jstate.opt, step=jnp.asarray(3, jnp.int32),
               m=jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
                              jstate.opt["m"]))
    jstate = jsteps.TrainState(jstate.params, opt)
    jck.save_checkpoint(str(tmp_path), jstate, step=3)
    cfg, trainer = _mk_trainer(tmp_path, steps=4)
    trainer.init_or_restore()
    assert trainer.start_step == 3
    got = leaves([trainer.state.params, trainer.state.opt])
    want = jax.tree.leaves([jstate.params, jstate.opt])
    assert len(got) == len(want)
    for t, w in zip(got, want):
        assert _bits(t) == _jax_bits(w)
    state = trainer.run(_batches(cfg), prefetch=False)
    assert int(state.opt["step"]) == 4


def test_port_train_state_restores_into_jax(tmp_path):
    cfg, trainer = _mk_trainer(tmp_path, steps=3)
    state = trainer.run(_batches(cfg), prefetch=False)
    jm, _ = _jax_pair()
    out = jck.restore_checkpoint(str(tmp_path), jsteps.abstract_train_state(jm))
    assert int(out.opt["step"]) == 3
    got = jax.tree.leaves([out.params, out.opt])
    want = leaves([state.params, state.opt])
    assert len(got) == len(want)
    for w, t in zip(got, want):
        assert _jax_bits(w) == _bits(t)


@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b", "mamba2-780m",
                                  "jamba-v0.1-52b", "whisper-large-v3", "internvl2-1b"])
def test_launcher_trains_each_family_on_the_cpu(arch, capsys):
    assert launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--steps", "4", "--seq", "64", "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "[train] done at step 4; stragglers=" in out
    assert "[trainer] step 4 loss=" in out


def test_launcher_refuses_a_missing_card_and_sharded_meshes(monkeypatch):
    """A missing card raises as before, with a mesh too; a mesh whose ranks
    are not there (no torchrun world) raises ``ValueError`` naming both
    sizes (the sharded launcher: ``test_torch_train_sharded.py``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for extra in ([], ["--mesh-shape", "2,2"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.main(["--arch", "smollm-135m", "--smoke", "--steps", "1"] + extra)
    for extra, need in ((["--mesh-shape", "2,2"], 4), (["--mesh-shape", "production"], 256),
                        (["--multi-pod"], 512), (["--mesh-shape", "4"], 4)):
        with pytest.raises(ValueError, match=f"needs {need} ranks, the world has 1"):
            launch_train.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                               "--steps", "1"] + extra)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="needs 4 ranks, the world has 2"):
        launch_train.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                           "--steps", "1", "--mesh-shape", "2,2"])

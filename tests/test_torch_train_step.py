"""Port parity of the train step (``repro_torch.train.steps``) against JAX's
``value_and_grad(Model.loss)`` followed by ``adamw_update``, called directly
(JAX's own ``make_train_step`` is red under JAX 0.9, ROADMAP C).

The state starts as a JAX ``TrainState`` carried across by
``interop.train_state_from_jax``. Each step of the port is held to JAX from
the same state: the loss (rtol 1e-5) and every gradient leaf (1e-4 *
max|JAX leaf|) against JAX's ``value_and_grad`` at the port's params, then
the new params and AdamW state against JAX's ``adamw_update`` of the port's
gradients (rtol 1e-6 plus 1e-6 * max|leaf|, bf16 params equal, as
``test_torch_adamw.py``). Chaining JAX's own steps instead would compound a
known effect: Adam's first moves are sign(g) * lr, so an element whose
gradient is within the gradient tolerance of 0 may step either way (jamba's
smoke config: 32 such elements after one step, 0.011 * max|leaf|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JO
from repro.train.steps import TrainState as JTrainState
from repro_torch import interop
from repro_torch.launch import mesh as ML
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.optim import adamw as TO
from repro_torch.train import steps as TS

from _torch_lm_parity import (GRAD_REL, LOSS_RTOL, assert_grads_close, batch_pair,
                              jax_value_and_grad, pair, to_np, train_batch)

torch.set_num_threads(1)

TCFG = TO.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=6)
JCFG = JO.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=6)


def _to_jax(tree):
    """A port tree (tensors) as JAX arrays of the same dtypes."""
    return jax.tree.map(lambda t: jnp.asarray(t.detach().float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else
        jnp.int32 if t.dtype == torch.int32 else jnp.float32), tree)


def _assert_update(got, want):
    for t, w in zip(TO.leaves(got), jax.tree.leaves(want)):
        assert str(t.dtype).split(".")[-1] == str(w.dtype)
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(to_np(t), to_np(w))
        else:
            w = np.asarray(w)
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())


def _spy_grads(monkeypatch):
    """The gradients each train step hands to ``adamw_update``."""
    seen = []
    real = TS.adamw.adamw_update

    def spy(cfg, grads, opt, params, **kw):
        seen.append(grads)
        return real(cfg, grads, opt, params, **kw)

    monkeypatch.setattr(TS.adamw, "adamw_update", spy)
    return seen


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("arch,fp32", [("smollm-135m", True), ("jamba-v0.1-52b", True),
                                       ("smollm-135m", False)],
                         ids=["smollm-fp32", "jamba-fp32", "smollm-bf16"])
def test_steps_from_a_jax_state_match_jax(monkeypatch, arch, fp32, n_steps):
    jm, params, tm = pair(arch, fp32)
    jstate = JTrainState(params, JO.adamw_init(params))
    state = interop.train_state_from_jax(jax.tree.map(np.asarray, jstate), tm.cfg, "cpu")
    for t, w in zip(TO.leaves(state.params), jax.tree.leaves(params)):
        np.testing.assert_array_equal(to_np(t), to_np(w))
    assert state.opt["step"].dtype == torch.int32 and int(state.opt["step"]) == 0
    seen = _spy_grads(monkeypatch)
    step = TS.make_train_step(tm, (1, 1), TCFG)
    vg = jax_value_and_grad(jm)
    for i in range(n_steps):
        jb, tb = batch_pair(train_batch(jm, 2, 64, seed=10 + i), bf16_floats=not fp32)
        jp, jo = _to_jax(state.params), _to_jax(state.opt)
        (jl, jmet), jg = vg(jp, jb)
        state, met = step(state, tb)
        assert set(met) == {"loss", "xent", "aux", "grad_norm", "lr"}
        assert int(state.opt["step"]) == i + 1
        if fp32:
            np.testing.assert_allclose(float(met["loss"]), float(jl), rtol=LOSS_RTOL)
            np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]), rtol=LOSS_RTOL)
            assert_grads_close(TO.leaves(seen[-1]), jg, GRAD_REL)
        else:  # bf16: the loss only (XLA keeps excess precision inside jit)
            assert abs(float(met["loss"]) - float(jl)) <= 0.02
        new_p, new_o, om = JO.adamw_update(JCFG, _to_jax(seen[-1]), jo, jp)
        _assert_update(state.params, new_p)
        for key in ("m", "v", "master"):
            _assert_update(state.opt[key], new_o[key])
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(met[key]), float(om[key]), rtol=1e-6)


def test_microbatches_match_the_unsplit_step(monkeypatch):
    """``REPRO_MICROBATCH=2``: the mean of two half-batch gradients, against
    the port's own step on the whole batch (fp32 sums in another order:
    loss rtol 1e-6, gradients within 1e-5 * max|leaf|)."""
    jm, _, tm = pair("smollm-135m", True)
    tm = build_model(tm.cfg, "cpu")  # init_train_state draws the model's own weights
    state = TS.init_train_state(tm, torch.Generator().manual_seed(1), TCFG)
    bn = train_batch(jm, 4, 32, seed=20)
    _, tb = batch_pair(bn, bf16_floats=False)
    seen = _spy_grads(monkeypatch)
    whole = TS.make_train_step(tm, None, TCFG)
    monkeypatch.setenv("REPRO_MICROBATCH", "2")
    split = TS.make_train_step(tm, None, TCFG)
    s1, m1 = whole(state, tb)
    s2, m2 = split(state, tb)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    assert float(m2["xent"]) == float(m2["loss"])  # JAX's microbatch metrics
    assert float(m2["aux"]) == 0.0
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
    for a, b in zip(TO.leaves(seen[1]), TO.leaves(seen[0])):
        assert a.dtype == torch.float32
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert int(s2.opt["step"]) == 1
    monkeypatch.setenv("REPRO_MICROBATCH", "3")
    with pytest.raises(ValueError, match="microbatches"):
        TS.make_train_step(tm, None, TCFG)(state, tb)


def test_score_bf16_switch_is_set_for_the_step_and_reset(monkeypatch):
    jm, _, tm = pair("smollm-135m", True)
    tm = build_model(tm.cfg, "cpu")
    state = TS.init_train_state(tm, torch.Generator().manual_seed(1), TCFG)
    _, tb = batch_pair(train_batch(jm, 2, 32, seed=21), bf16_floats=False)
    seen = []
    real = TA._chunk_step
    monkeypatch.setattr(TA, "_chunk_step", lambda *a: seen.append(a[-1]) or real(*a))
    monkeypatch.setenv("REPRO_SCORE_BF16", "1")
    _, met = TS.make_train_step(tm, None, TCFG)(state, tb)
    assert seen and set(seen) == {torch.bfloat16}
    assert TA._BLOCK_CONFIG["score_dtype"] is None
    assert np.isfinite(float(met["loss"]))


def test_a_mesh_of_more_than_one_device_raises():
    """Without its ranks (no torch.distributed world) a mesh of more than one
    device raises ``ValueError``; one device runs on an abstract mesh of one
    device (the sharded step: ``test_torch_train_sharded.py``). A shape
    tuple names its axes as the launcher's ``--mesh-shape`` does."""
    _, _, tm = pair("smollm-135m", True)
    for mesh in ((2, 1), (1, 4), (16, 16), (4,), ML.Mesh((2, 2, 1), ("pod", "data", "model")),
                 ML.make_production_mesh(), ML.make_production_mesh(multi_pod=True),
                 ML.Mesh((4,), ("data",))):
        with pytest.raises(ValueError, match="no ranks: it needs a torch.distributed world"):
            TS.make_train_step(tm, mesh, TCFG)
    with pytest.raises(ValueError, match="one distinct name per axis"):
        TS.resolve_mesh((2, 2, 1))
    for mesh, shape in (((1, 1), {"data": 1, "model": 1}), ((1,), {"data": 1}),
                        (None, {"data": 1, "model": 1}),
                        (ML.Mesh((1, 1), ("data", "model")), {"data": 1, "model": 1})):
        got = TS.resolve_mesh(mesh)
        assert got.abstract and got.shape == shape
        TS.make_train_step(tm, mesh, TCFG)


def test_abstract_state_has_the_state_layout():
    tm = build_model(pair("jamba-v0.1-52b", True)[2].cfg, "cpu")
    state = TS.init_train_state(tm, torch.Generator().manual_seed(2), TCFG)
    abstract = TS.abstract_train_state(tm)
    for tree, atree in ((state.params, abstract.params), (state.opt, abstract.opt)):
        got, want = TO.leaves(atree), TO.leaves(tree)
        assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want]
        assert all(t.device.type == "meta" for t in got)

"""Tensor- and sequence-parallel training: the port's train step on meshes
with a ``model`` axis, each rank computing on its blocks along JAX's four
activation rules (``repro_torch.distributed.tp``).

One world of 4 gloo ranks (``tests/_torch_tp_ranks.py``, in a subprocess
with a timeout) runs every case of this file in turn: the smoke config of
smollm-135m (2 KV heads: head-parallel at m = 2, sequence-parallel at
m = 4) on (1, 2), (1, 4) and (2, 2) over (data, model) and (2, 2, 1) over
(pod, data, model), and on (1, 2) and (1, 4) with the residual stream
whole on every rank (``REPRO_RESIDUAL_SEQ=0``); whisper-large-v3 and
internvl2-1b on (1, 2).
``test_torch_tp_train_moe_ssm.py`` runs deepseek-moe-16b, mamba2-780m and
jamba-v0.1-52b on the four meshes through the same checks. Three fp32
steps each from the seeded state; each step, from the state it started
from, is held to:

* the port's one-device loss and gradients (which ``test_torch_train_*``
  hold to JAX): loss and aux rtol 1e-5, every gradient leaf, gathered,
  within 1e-4 * max|leaf|; the MoE routes and drops equal (a rank's rows:
  its block of the batch's groups);
* its own update: the grad norm within rtol 1e-6 of the gathered
  gradients' norm, and the new params and AdamW state bit-equal to
  ``adamw_update`` of the gathered gradients with the step's norm;
* once per arch (its first case's first step), JAX's unsharded
  ``value_and_grad(Model.loss)``, at the same tolerances (one jitted
  function, static in the arch).

The world computes the one-device steps and the comparisons (each rank a
share of the cases; every rank holds the gathered records) and returns
the numbers this file holds to the tolerances.

Also from the world: each rank's matmul FLOPs of one smollm step
(``FlopCounterMode``, forward and backward) are at most 0.6x the one-device
step's on (1, 2) and 0.4x on (1, 4), and the dry-run's count of rank 0's
step in a fake world (``launch.dryrun``) equals them; on (1, 2) no
Megatron-aligned leaf (gate, up, down, wq, wk, wv, wo, table) is gathered
over ``model``.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild
from repro_torch.distributed import sharding as shd
from repro_torch.optim import adamw as TO
from repro_torch.train import steps as TS

import _torch_tp_ranks as W
from _torch_lm_parity import GRAD_REL, LOSS_RTOL

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
GNORM_RTOL = 1e-6
GROUP = "dense"
CASES = W.train_cases(GROUP)


def run_world(tmp_path_factory, group):
    out = tmp_path_factory.mktemp("tp_train") / "out.pt"
    script = (f"import sys; sys.path.insert(0, {str(ROOT / 'tests')!r}); "
              f"import _torch_tp_ranks as W; W.main('train', {str(out)!r}, {group!r})")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, f"stderr:\n{res.stderr}\nstdout:\n{res.stdout}"
    return torch.load(out, weights_only=False)


def jax_value_and_grad(archs):
    """The one jitted JAX ``value_and_grad(Model.loss)``, static in the arch."""
    jms = {a: jbuild(dataclasses.replace(JARCHS[a].smoke(), **W.FP32)) for a in archs}

    def vg(arch, params, batch):
        return jax.value_and_grad(jms[arch].loss, has_aux=True)(params, batch)

    return jax.jit(vg, static_argnums=0)


def _jax_batch(b):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jnp.float32)
            for k, v in b.items()}


def _grads_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w, dtype=np.float32)
        assert tuple(g.shape) == w.shape
        assert np.abs(g.float().numpy() - w).max() <= GRAD_REL * np.abs(w).max()


def check_case(world, cases, case):
    cid = W.case_id(case)
    steps = world["ranks"][cases.index(case) % W.WORLD]["cmp"][cid]
    assert len(steps) == W.STEPS
    for st in steps:
        np.testing.assert_allclose(*st["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(*st["aux"], rtol=LOSS_RTOL, atol=1e-12)
        assert st["grad_shapes"] and st["grad_err"] <= GRAD_REL
        assert st["routes"]
        assert (st["n_routes"] > 0) == bool(W.model_of(case[0]).cfg.n_experts)
        np.testing.assert_allclose(*st["gnorm"], rtol=GNORM_RTOL)
        assert st["update_bits"] and st["lr_bits"]


def check_jax(world, oracle, arch):
    """The arch's first case, first step, against JAX's unsharded
    ``value_and_grad`` from the same state."""
    first = world["ranks"][0]["first"][arch]
    batch = world["data"][arch][0]
    (jl, jmet), jg = oracle(arch, jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                               first["params"]), _jax_batch(batch))
    np.testing.assert_allclose(first["loss"], float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(first["aux"], float(jmet["aux"]), rtol=LOSS_RTOL, atol=1e-12)
    _grads_close(first["grads"], jax.tree.leaves(jg))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory, GROUP)


@pytest.fixture(scope="module")
def oracle():
    return jax_value_and_grad(W.TRAIN_GROUPS[GROUP])


@pytest.mark.parametrize("case", CASES, ids=W.case_id)
def test_tp_steps_match_the_one_device_step(world, case):
    check_case(world, CASES, case)


@pytest.mark.parametrize("arch", W.TRAIN_GROUPS[GROUP])
def test_tp_step_matches_jax_value_and_grad(world, oracle, arch):
    check_jax(world, oracle, arch)


@pytest.mark.parametrize("mesh,limit", [("1x2", 0.6), ("1x4", 0.4)])
def test_each_rank_does_a_share_of_the_matmul_flops(world, mesh, limit):
    flops = world["ranks"][0]["flops"]
    assert 0 < flops[mesh] <= limit * flops["one"]


@pytest.fixture(scope="module")
def fake_flops(tmp_path_factory):
    """Rank 0's FLOPs of the same step as the dry-run counts them, in a fake
    world (``tests/_torch_dryrun_cells.py``, in a subprocess)."""
    out = tmp_path_factory.mktemp("tp_flops") / "out.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_dryrun_cells.py"),
                          "tp_flops", str(out)], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, f"stderr:\n{res.stderr}\nstdout:\n{res.stdout}"
    return json.loads(out.read_text())


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_dryrun_counts_rank0s_flops(world, fake_flops, mesh):
    assert fake_flops[mesh] == world["ranks"][0]["flops"][mesh] > 0


def test_aligned_blocks_are_not_gathered(world):
    """On (1, 2) every Megatron-aligned leaf is used as its stored block:
    of the weights (at most 2-D: the rest are the residual's seq blocks),
    only the norms' scales (split by the fallback rule) are gathered."""
    tm = W.model_of("smollm-135m")
    stub = types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 1, "model": 2})
    params = TS.abstract_train_state(tm).params
    specs = shd.param_specs(params, stub)
    aligned = set()
    for path, leaf, spec in zip(_paths(params), TO.leaves(params), TO.leaves(specs)):
        name = path[-2] if path[-1] in ("w", "b") else path[-1]
        if name in ("gate", "up", "down", "wq", "wk", "wv", "wo", "table"):
            local = shd.local_shape(leaf.shape, spec, stub)
            aligned.add(local if name == "table" else local[1:])
    moved = [m for m in world["ranks"][0]["moves"] if len(m[0]) <= 2]
    assert moved, "the norms' scales are gathered"
    for shape, _ in moved:
        assert shape not in aligned and len(shape) == 1


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    return [prefix]

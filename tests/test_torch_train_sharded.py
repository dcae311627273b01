"""Port parity of the sharded train step (``repro_torch.train.steps`` on a
``repro_torch.launch.mesh`` mesh with ranks), the mesh-aware ``Trainer``
and the launcher's ``--mesh-shape``.

One world of 4 gloo ranks (``tests/_torch_sharded_ranks.py``, in a
subprocess with a timeout) runs every mesh in turn: (2, 2), (4, 1) and
(1, 4) over (data, model) and (2, 2, 1) over (pod, data, model), three fp32
steps each of the smoke configs of smollm-135m (dense), deepseek-moe-16b
(MoE, 128 tokens a row: at least one 128-token group a rank) and
mamba2-780m (SSM), from the seeded single-device state. Each step is held,
from the state it started from, to:

* JAX's ``value_and_grad(Model.loss)`` (JAX's own sharded step is red under
  JAX 0.9, ROADMAP C): loss rtol 1e-5, every reduced gradient leaf within
  1e-4 * max|JAX leaf| (``_torch_lm_parity``'s ``LOSS_RTOL`` / ``GRAD_REL``);
* the port's single-device loss and gradients, at the same tolerances;
* the single-device ``adamw_update`` of the same reduced gradients
  (gathered over ``model`` from each rank's blocks: on a ``model`` axis of
  more than one rank the step computes on its blocks) with the step's grad
  norm: new params, m, v, master and lr bit-equal; the grad norm bit-equal
  to the reduced gradients' on a ``model`` axis of one rank, within rtol
  1e-6 on more (each rank's sum of squares, all-reduced).

Each rank's leaves have the local shapes that JAX's specs give (JAX's
``param_specs`` / ``opt_specs`` on a stub mesh, as in
``test_torch_sharding.py``). Also from the world: a MoE batch whose
per-rank tokens split the 128-token groups raises ``ValueError``; a (2, 2)
checkpoint restores bit for bit into (4, 1), one device and JAX's
``restore_checkpoint``; a SIGTERM on one rank stops every rank at the same
step, checkpointed. The JAX oracle is one jitted function, static in the
arch (three compiles of ~2-3 s here); torch runs on one thread.
"""

import os
import pathlib
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro.distributed import sharding as jshd
from repro.train import steps as jsteps
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.distributed import sharding as shd
from repro_torch.optim import adamw as TO
from repro_torch.train import steps as TS

import _torch_sharded_ranks as W
from _torch_lm_parity import GRAD_REL, LOSS_RTOL, pair

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 600
CASES = [(arch, mesh) for arch in W.ARCH_SEQ for mesh in W.MESHES]


def _bits(t):
    t = torch.as_tensor(np.asarray(t)) if not isinstance(t, torch.Tensor) else t
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _jax_bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else
                  np.uint32 if a.dtype.itemsize == 4 else np.uint8).tobytes()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    script = (f"import sys; sys.path.insert(0, {str(ROOT / 'tests')!r}); "
              f"import _torch_sharded_ranks as W; "
              f"W.main({str(tmp / 'out.pt')!r}, {str(tmp)!r})")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert res.returncode == 0, f"stderr:\n{res.stderr}\nstdout:\n{res.stdout}"
    out = torch.load(tmp / "out.pt", weights_only=False)
    out["tmp"] = tmp
    return out


@pytest.fixture(scope="module")
def oracle():
    """arch -> (JAX model, port model), and the one jitted JAX
    ``value_and_grad(Model.loss)``, static in the arch."""
    models = {arch: pair(arch, True) for arch in W.ARCH_SEQ}

    def vg(arch, params, batch):
        return jax.value_and_grad(models[arch][0].loss, has_aux=True)(params, batch)

    return models, jax.jit(vg, static_argnums=0)


def _to_jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tree)


@pytest.mark.parametrize("arch,mesh", CASES, ids=[f"{a}-{m}" for a, m in CASES])
def test_sharded_steps_match_jax_and_the_single_device_step(world, oracle, arch, mesh):
    models, vg = oracle
    jm, _, tm = models[arch]
    records = world["ranks"][0]["steps"][arch, mesh]
    assert len(records) == W.STEPS
    for rec, b in zip(records, world["data"][arch]):
        before, grads, after, met = rec["before"], rec["grads"], rec["after"], rec["metrics"]
        (jl, jmet), jg = vg(arch, _to_jax(before.params), {k: jnp.asarray(v, jnp.int32)
                                                            for k, v in b.items()})
        np.testing.assert_allclose(float(met["loss"]), float(jl), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]), rtol=LOSS_RTOL,
                                   atol=1e-12)
        tl, _, tg = _single(tm, before, b)
        np.testing.assert_allclose(float(met["loss"]), float(tl), rtol=LOSS_RTOL)
        for g, w, t in zip(grads, jax.tree.leaves(jg), tg):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            assert np.abs(g.numpy() - w).max() <= GRAD_REL * np.abs(w).max()
            assert float((g - t).abs().max()) <= GRAD_REL * float(t.abs().max())
        gnorm = TO.global_norm(grads)
        if dict(zip(W.MESHES[mesh][1], W.MESHES[mesh][0])).get("model", 1) == 1:
            assert _bits(met["grad_norm"]) == _bits(gnorm)
        else:
            np.testing.assert_allclose(float(met["grad_norm"]), float(gnorm), rtol=1e-6)
        ref_p, ref_o, om = TO.adamw_update(W.TCFG, TO.unflatten(before.params, grads),
                                           before.opt, before.params, gnorm=met["grad_norm"])
        for got, want in ((after.params, ref_p), (after.opt, ref_o)):
            for x, y in zip(TO.leaves(got), TO.leaves(want)):
                assert x.dtype == y.dtype and x.shape == y.shape
                assert _bits(x) == _bits(y)
        assert _bits(met["lr"]) == _bits(om["lr"])


def _single(tm, state, batch):
    """The port's single-device loss, metrics and gradients at ``state``."""
    leaves = [p.detach().requires_grad_(True) for p in TO.leaves(state.params)]
    loss, met = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                        TO.unflatten(state.params, leaves))
    return loss.detach(), met, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch,mesh", CASES, ids=[f"{a}-{m}" for a, m in CASES])
def test_each_rank_holds_the_blocks_of_jax_specs(world, oracle, arch, mesh):
    jm = oracle[0][arch][0]
    shape, axes = W.MESHES[mesh]
    stub = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    aparams = jm.abstract_params()
    p_specs = jax.tree.leaves(jshd.param_specs(aparams, stub),
                              is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    o_specs = jax.tree.leaves(jshd.opt_specs(aparams, stub),
                              is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    full = [tuple(a.shape) for a in jax.tree.leaves(aparams)]
    n = len(full)
    for r, rank in enumerate(world["ranks"]):
        shapes = rank["shapes"][arch, mesh]
        # params, then m, master, step, v (the opt dict's keys in order)
        want = [shd.local_shape(s, shd.P(*p), stub) for s, p in zip(full, p_specs)]
        opt = [shd.local_shape(s, shd.P(*o), stub) for s, o in zip(full, o_specs)]
        assert shapes == want + opt + opt + [()] + opt, f"rank {r}"
        if stub.shape.get("data", 1) * stub.shape.get("pod", 1) > 1 and r == 0:
            assert any(a != b for a, b in zip(want, opt))  # ZeRO-1 engages
        assert len(shapes) == 4 * n + 1


def test_microbatches_on_a_mesh_match_the_unsplit_sharded_step(world):
    """``REPRO_MICROBATCH=2`` on (2, 2): each rank's rows in two microbatches,
    against the sharded step on them whole (fp32 sums in another order: loss
    rtol 1e-6, gradients within 1e-5 * max|leaf|, as the one-device test)."""
    whole, split = world["ranks"][0]["microbatches"]
    np.testing.assert_allclose(float(split[-1]), float(whole[-1]), rtol=1e-6)
    for a, b in zip(split[:-1], whole[:-1]):
        assert a.dtype == torch.float32
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_a_moe_batch_that_splits_the_token_groups_raises(world):
    for rank in world["ranks"]:
        assert rank["moe_refusal"] is not None and "groups of 128" in rank["moe_refusal"]


def test_checkpoints_are_elastic_across_meshes_and_packages(world, oracle):
    el = [r["elastic"] for r in world["ranks"]]
    saved, restored = el[0]["saved"], el[0]["restored"]
    assert all(e["start_step"] == 2 for e in el)
    assert int(saved.opt["step"]) == 2
    got, want = TO.leaves([restored.params, restored.opt]), TO.leaves([saved.params, saved.opt])
    assert len(got) == len(want)
    assert all(_bits(x) == _bits(y) for x, y in zip(got, want))
    ckpt = str(world["tmp"] / "elastic")
    tm = oracle[0]["smollm-135m"][2]
    one = restore_checkpoint(ckpt, TS.abstract_train_state(tm), device="cpu")
    assert all(_bits(x) == _bits(y) for x, y in zip(TO.leaves([one.params, one.opt]), want))
    jm = oracle[0]["smollm-135m"][0]
    jout = jck.restore_checkpoint(ckpt, jsteps.abstract_train_state(jm))
    jl = jax.tree.leaves([jout.params, jout.opt])
    assert len(jl) == len(want)
    assert all(_jax_bits(a) == _bits(t) for a, t in zip(jl, want))


def test_a_sigterm_on_one_rank_checkpoints_every_rank_at_one_step(world):
    runs = [r["sigterm"] for r in world["ranks"]]
    assert [r["final_step"] for r in runs] == [3, 3, 3, 3]
    assert all(r["latest"] == 3 and r["preempted"] for r in runs)


def test_torchrun_launcher_trains_on_a_2x2_gloo_mesh(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "4",
         "--master-addr", "127.0.0.1", "--master-port", str(port),
         "-m", "repro_torch.launch.train", "--arch", "smollm-135m", "--smoke",
         "--device", "cpu", "--mesh-shape", "2,2", "--steps", "4", "--seq", "64",
         "--batch", "4"],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, f"stderr:\n{res.stderr[-4000:]}\nstdout:\n{res.stdout}"
    losses = [float(line.split("loss=")[1].split()[0]) for line in res.stdout.splitlines()
              if line.startswith("[trainer] step ")]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert res.stdout.count("[train] done at step 4") == 1

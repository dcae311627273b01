"""The rank side of ``test_torch_train_sharded.py``: one world of 4 gloo
ranks (``group.run_ranks``) that runs every mesh of the file in turn. It
imports no JAX: the spawned ranks import this module by name.

``main(out_path, tmp)`` runs the world and saves its records (rank 0's
steps, every rank's local shapes and refusals) with ``torch.save``.
"""

import dataclasses
import os
import signal

import numpy as np
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.configs import ARCHS
from repro_torch.distributed import group as tGR
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as ML
from repro_torch.launch import train as TL
from repro_torch.models import build_model
from repro_torch.optim import adamw as TO
from repro_torch.train import steps as TS
from repro_torch.train.trainer import Trainer, TrainerConfig

FP32 = dict(param_dtype="float32", compute_dtype="float32")
ARCH_SEQ = {"smollm-135m": 64, "deepseek-moe-16b": 128, "mamba2-780m": 64}
MESHES = {"2x2": ((2, 2), ("data", "model")), "4x1": ((4, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "pod2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
BATCH, STEPS, SEED = 4, 3, 0
TCFG = TO.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=6)


def model_of(arch):
    return build_model(dataclasses.replace(ARCHS[arch].smoke(), **FP32), "cpu")


def batches(arch):
    """The numpy batches of each step: tokens and targets (BATCH, seq)."""
    rng = np.random.default_rng(100 + sorted(ARCH_SEQ).index(arch))
    return [{k: rng.integers(0, 256, (BATCH, ARCH_SEQ[arch])) for k in ("tokens", "targets")}
            for _ in range(STEPS)]


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _steps(rank, arch, mesh_name, data):
    """STEPS sharded steps from the seeded state: rank 0's record of each
    step (the full state before and after, the reduced gradients the update
    took, gathered over ``model`` from the rank's blocks, the metrics), and
    this rank's local shapes."""
    model = model_of(arch)
    mesh = ML.make_mesh(*MESHES[mesh_name], device="cpu")
    full = TS.init_train_state(model, torch.Generator().manual_seed(SEED), TCFG)
    specs = TS.state_specs(model, mesh)
    state = TS.shard_state(full, specs, mesh)
    shapes = [tuple(t.shape) for t in TO.leaves([state.params, state.opt])]
    seen = []
    real = shd.mean_over

    def spy(tensors, mesh_, axes):
        out = real(tensors, mesh_, axes)
        seen.append(out)
        return out

    step = TS.make_train_step(model, mesh, TCFG)
    records = []
    n_leaves = len(TO.leaves(full.params))
    shd.mean_over = spy
    try:
        for b in data:
            state, met = step(state, _tensors(b))
            after = TS.gather_state(state, specs, mesh)
            grads = [shd.gather(g, s, mesh, axes=("model",))
                     for g, s in zip(seen[-1][:n_leaves], TO.leaves(specs.params))]
            records.append(dict(before=full, grads=grads, after=after,
                                metrics={k: v.clone() for k, v in met.items()}))
            full = after
    finally:
        shd.mean_over = real
    return (records if rank == 0 else None), shapes


def _microbatches(rank, data):
    """One (2, 2) step of smollm with and without ``REPRO_MICROBATCH=2``
    (each rank's two rows as two microbatches): rank 0's losses and reduced
    gradients."""
    model = model_of("smollm-135m")
    mesh = ML.make_mesh(*MESHES["2x2"], device="cpu")
    full = TS.init_train_state(model, torch.Generator().manual_seed(SEED), TCFG)
    specs = TS.state_specs(model, mesh)
    n_leaves = len(TO.leaves(full.params))
    out, real = [], shd.mean_over

    def spy(tensors, mesh_, axes):
        reduced = real(tensors, mesh_, axes)
        out.append(reduced[:n_leaves + 1])  # the gradients and the loss
        return reduced

    shd.mean_over = spy
    try:
        for k in ("1", "2"):
            os.environ["REPRO_MICROBATCH"] = k
            TS.make_train_step(model, mesh, TCFG)(TS.shard_state(full, specs, mesh),
                                                  _tensors(data[0]))
    finally:
        shd.mean_over = real
        del os.environ["REPRO_MICROBATCH"]
    return out if rank == 0 else None


def _moe_refusal(data):
    """deepseek on (4, 1) with 64 tokens a rank: the groups of 128 split."""
    model = model_of("deepseek-moe-16b")
    mesh = ML.make_mesh(*MESHES["4x1"], device="cpu")
    state = TS.shard_state(TS.init_train_state(model, torch.Generator().manual_seed(SEED), TCFG),
                           TS.state_specs(model, mesh), mesh)
    b = {k: v[:, :64] for k, v in _tensors(data[0]).items()}
    try:
        TS.make_train_step(model, mesh, TCFG)(state, b)
    except ValueError as e:
        return str(e)
    return None


def _trainer(mesh_name, ckpt_dir, steps, ckpt_every=100):
    cfg = dataclasses.replace(ARCHS["smollm-135m"].smoke(), **FP32)
    mesh = ML.make_mesh(*MESHES[mesh_name], device="cpu")
    return Trainer(build_model(cfg, "cpu"), mesh, TrainerConfig(
        total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir, log_every=1,
        opt=TO.AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=1)))


def _elastic(rank, tmp):
    """A (2, 2) trainer checkpoints at step 2; a (4, 1) trainer restores it."""
    ckpt = os.path.join(tmp, "elastic")
    t22 = _trainer("2x2", ckpt, 2, ckpt_every=2)
    t22.run(TL.token_batches(t22.model, 64, BATCH, seed=1),
            torch.Generator().manual_seed(SEED), prefetch=False)
    saved = t22.full_state()
    t41 = _trainer("4x1", ckpt, 4)
    t41.init_or_restore()
    restored = t41.full_state()
    return dict(saved=saved if rank == 0 else None, restored=restored if rank == 0 else None,
                start_step=t41.start_step, losses=[m["loss"] for m in t22.metrics_log])


def _sigterm(rank, tmp):
    """Rank 1 receives a SIGTERM while it reads step 3's batch: every rank
    checkpoints at step 3 and stops."""
    ckpt = os.path.join(tmp, "preempt")
    trainer = _trainer("2x2", ckpt, 6)

    def stream():
        for i, b in enumerate(TL.token_batches(trainer.model, 64, BATCH, seed=2)):
            if rank == 1 and i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    state = trainer.run(stream(), torch.Generator().manual_seed(SEED), prefetch=False)
    return dict(final_step=int(state.opt["step"]), latest=latest_step(ckpt),
                preempted=trainer._preempted)


def _world(rank, nprocs, data, tmp):
    out = {"steps": {}, "shapes": {}}
    for arch in ARCH_SEQ:
        for mesh_name in MESHES:
            records, shapes = _steps(rank, arch, mesh_name, data[arch])
            out["steps"][arch, mesh_name] = records
            out["shapes"][arch, mesh_name] = shapes
    out["microbatches"] = _microbatches(rank, data["smollm-135m"])
    out["moe_refusal"] = _moe_refusal(data["deepseek-moe-16b"])
    out["elastic"] = _elastic(rank, tmp)
    out["sigterm"] = _sigterm(rank, tmp)
    return out


def main(out_path, tmp):
    data = {arch: batches(arch) for arch in ARCH_SEQ}
    ranks = tGR.run_ranks(_world, 4, (data, tmp), timeout_s=500)
    torch.save(dict(data=data, ranks=ranks), out_path)

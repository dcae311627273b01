"""Training launcher.

    python -m repro_torch.launch.train --arch smollm-135m --smoke --steps 20 --device cpu
    python -m repro_torch.launch.train --arch smollm-135m --batch 8 --seq 2048
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch smollm-135m \
        --smoke --device cpu --mesh-shape 2,2

Port of ``repro.launch.train`` with its flags, for every family of
``ARCHS``: ``--smoke`` takes the reduced config; the weights are random
(a CPU ``torch.Generator`` seeded 0), the batches ``SyntheticTokens``
(seed 0), with random frames for encdec and patches for vlm (JAX's launcher
feeds tokens only, which those two families' ``loss`` cannot take);
checkpoints, preemption handling and straggler accounting come
from ``Trainer``. ``--device`` defaults to ``cuda``, which raises without a
card.

Meshes, as in JAX's launcher: ``--mesh-shape d,m`` over the axes (``data``,
``model``); ``production`` the (16, 16) mesh, ``--multi-pod`` the (2, 16,
16) one over (``pod``, ``data``, ``model``); no flag, one device. A mesh
runs one process per device, each reading the whole batch stream, from
which the train step takes its rows. The ranks come from ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, the rendezvous in
``MASTER_ADDR`` / ``MASTER_PORT``), or from a process group the caller has
initialised. A world whose size is not the mesh's raises ``ValueError``.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch.configs import ARCHS, get_arch
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.distributed import group as _group
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. '2,2' (axes data,model) or 'production'; default: one device")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def make_trainer(argv=None):
    """(trainer, batches) of the launcher's arguments: the ``Trainer`` with
    the launcher's ``AdamWConfig(lr, total_steps=steps, warmup_steps=
    max(steps // 10, 1))`` and an endless iterator of token batches."""
    args = _parser().parse_args(argv)
    _device.resolve(args.device)
    mesh = _launch_mesh(args.mesh_shape, args.multi_pod, args.device)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build_model(cfg, args.device)

    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 10, 1))
    trainer = Trainer(model, mesh, TrainerConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, log_every=max(args.steps // 10, 1),
        opt=opt))

    return trainer, token_batches(model, args.seq, args.batch)


def _launch_mesh(mesh_shape, multi_pod: bool, device):
    """The launcher's mesh: None without a flag; else a mesh of the flag's
    shape, abstract for one device outside a world, otherwise over the
    caller's process group or one joined from ``torchrun``'s environment
    (NCCL on ``cuda``, gloo on ``cpu``)."""
    if multi_pod or mesh_shape == "production":
        prod = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        shape, axes = tuple(prod.shape.values()), prod.axis_names
    elif mesh_shape:
        shape = tuple(int(x) for x in mesh_shape.split(","))
        axes = mesh_lib.SHAPE_AXES[:len(shape)]
    else:
        return None
    need = math.prod(shape)
    if dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != need:
        raise ValueError(f"a {shape} mesh over {axes} needs {need} ranks, the world has "
                         f"{world} (torchrun --nproc-per-node {need})")
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        _group.init_slab_group(int(os.environ["RANK"]), world, "env://", device)
    return mesh_lib.make_mesh(shape, axes, device)


def token_batches(model, seq: int, batch: int, seed: int = 0):
    """Endless train batches in ``model``'s layout for sequence length
    ``seq``: ``SyntheticTokens(seed)`` tokens and targets of the decoder's
    length (``dec_len(seq)`` for encdec, ``seq - n_patches`` for vlm), with
    N(0, 1) frames (B, seq, D) or patches (B, n_patches, D) in bf16 drawn by
    a numpy generator seeded ``seed + 1``."""
    cfg = model.cfg
    n_tok = model.dec_len(seq) if cfg.is_encdec else model.text_len(seq)
    extra = ("frames", seq) if cfg.is_encdec else ("patches", cfg.n_patches) \
        if cfg.family == "vlm" else None
    rng = np.random.default_rng(seed + 1)
    for tokens, targets in SyntheticTokens(cfg.vocab_size, n_tok, batch, seed=seed):
        out = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
        if extra:
            x = rng.standard_normal((batch, extra[1], cfg.d_model), dtype=np.float32)
            out[extra[0]] = torch.from_numpy(x).to(torch.bfloat16)
        yield out


def main(argv=None):
    joined = not dist.is_initialized()
    try:
        trainer, batches = make_trainer(argv)
        state = trainer.run(batches, generator=torch.Generator().manual_seed(0))
        if trainer.rank0:
            print(f"[train] done at step {int(state.opt['step'])}; "
                  f"stragglers={trainer.straggler_steps}")
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

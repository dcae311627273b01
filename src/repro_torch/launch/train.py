"""Training launcher.

    python -m repro_torch.launch.train --arch smollm-135m --smoke --steps 20 --device cpu
    python -m repro_torch.launch.train --arch smollm-135m --batch 8 --seq 2048

Port of ``repro.launch.train`` with its flags, for every family of
``ARCHS``: ``--smoke`` takes the reduced config; the weights are random
(a CPU ``torch.Generator`` seeded 0), the batches ``SyntheticTokens``
(seed 0), with random frames for encdec and patches for vlm (JAX's launcher
feeds tokens only, which those two families' ``loss`` cannot take);
checkpoints, preemption handling and straggler accounting come
from ``Trainer``. ``--device`` defaults to ``cuda``, which raises without a
card. Sharded training waits for ROADMAP A20.4: ``--mesh-shape`` of more
than one device, ``production`` and ``--multi-pod`` raise
``NotImplementedError``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.data.tokens import SyntheticTokens
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
                    help="e.g. '1,1' (axes data,model); default: one device")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def make_trainer(argv=None):
    """(trainer, batches) of the launcher's arguments: the ``Trainer`` with
    the launcher's ``AdamWConfig(lr, total_steps=steps, warmup_steps=
    max(steps // 10, 1))`` and an endless iterator of token batches."""
    args = _parser().parse_args(argv)
    if args.multi_pod or args.mesh_shape == "production":
        raise NotImplementedError("the production and multi-pod meshes: sharded training "
                                  "is not ported yet (ROADMAP A20.4)")
    mesh = tuple(int(x) for x in args.mesh_shape.split(",")) if args.mesh_shape else None

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
    trainer, batches = make_trainer(argv)
    state = trainer.run(batches, generator=torch.Generator().manual_seed(0))
    print(f"[train] done at step {int(state.opt['step'])}; "
          f"stragglers={trainer.straggler_steps}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

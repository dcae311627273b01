"""End-to-end LM training: a ~135M-param architecture (SmolLM, reduced or
full) trained on synthetic tokens through ``repro_torch.launch.train``'s
``Trainer`` (the sharded train step, AdamW with its schedule, checkpoints
and restart-on-relaunch).

    python examples_torch/train_lm.py --steps 200                 # reduced, on the card
    python examples_torch/train_lm.py --full --steps 300 --batch 8 --seq 2048
    python examples_torch/train_lm.py --device cpu --steps 20
"""

import argparse
import os
import tempfile

import _path  # noqa: F401
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import train as TL


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true",
                    help="full config (default: reduced smoke config)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 2,2 over (data, model), under torchrun; default one device")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoints (default: a new temporary directory)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.smoke()
    tot, act = cfg.param_counts()
    print(f"[train_lm] {cfg.name}: {tot / 1e6:.1f}M params ({act / 1e6:.1f}M active)")

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = args.ckpt_dir or os.path.join(tmp, "ckpt")
        trainer, batches = TL.make_trainer(
            ["--arch", args.arch, "--steps", str(args.steps), "--batch", str(args.batch),
             "--seq", str(args.seq), "--ckpt-dir", ckpt,
             "--ckpt-every", str(max(args.steps // 4, 10)), "--device", args.device]
            + ([] if args.full else ["--smoke"])
            + (["--mesh-shape", args.mesh_shape] if args.mesh_shape else []))
        state = trainer.run(batches, generator=torch.Generator().manual_seed(0))
    first = trainer.metrics_log[0]["loss"]
    last = trainer.metrics_log[-1]["loss"]
    print(f"[train_lm] loss {first:.3f} -> {last:.3f} over {int(state.opt['step'])} steps "
          f"(stragglers: {trainer.straggler_steps})")
    assert last < first, "loss did not improve"
    return trainer


if __name__ == "__main__":
    main()

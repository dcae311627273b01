"""Batched serving: prefill a prompt batch (kernel K6 for each
self-attention layer on the card), then greedy decode steps against the
KV / SSM cache.

    python examples_torch/serve_lm.py --arch mamba2-780m
    python examples_torch/serve_lm.py --arch qwen2-7b --gen 24
    python examples_torch/serve_lm.py --device cpu
"""

import argparse
import dataclasses

import _path  # noqa: F401
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.serve_lm import serve
from repro_torch.models import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # the smoke config at K6's head size 64 (the kernel takes 64 or 128)
    cfg = get_arch(args.arch).smoke()
    if cfg.n_heads:
        cfg = dataclasses.replace(cfg, head_dim=64)
    model = build_model(cfg, args.device).init(torch.Generator().manual_seed(0))
    b, p, g = args.requests, args.prompt, args.gen
    batch = model.make_batch(torch.Generator().manual_seed(1),
                             ShapeConfig("serve", p, b, "prefill"))["batch"]
    res = serve(model, batch, g)
    print(f"prefill {b}x{p}: {res.prefill_s:.2f}s")
    print(f"decode {g} steps x {b} reqs: {res.decode_s:.2f}s "
          f"({b * g / res.decode_s:.1f} tok/s, smoke config on {model.dev.type})")
    print("request 0 generated:", res.ids[0].tolist())
    return res


if __name__ == "__main__":
    main()

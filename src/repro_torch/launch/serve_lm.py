"""LM serving launcher: batched prefill + greedy decode loop.

    python -m repro_torch.launch.serve_lm --arch qwen1.5-0.5b --requests 8 \\
        --prompt-len 2048 --gen-len 64 [--device cuda] [--seed 0] [--smoke]

Port of ``repro.launch.serve_lm`` with its semantics, for every family of
``ARCHS``: a request batch (``Model.make_batch``: tokens, with frames for
encdec or patches for vlm) is prefilled through ``Model.prefill``
(last-position logits; the prefill's self-attention runs kernel K6 on the
card), the first token is the greedy ``argmax`` of those logits,
``make_cache(B, prompt + gen)`` makes the decode cache and ``gen`` tokens are
decoded greedily from position ``prompt`` (the prefill's sequence length:
tokens, patches + text tokens, or frames). As in the JAX launcher the
prompt's K/V, the SSM state and the encoder's cross K/V are not written into
that cache: decode attends to ``prompt`` zero slots besides its own tokens,
starts from a zero SSM state, and cross-attends to zeros (ROADMAP queue C).

Weights are random, drawn with the JAX package's scales from a CPU
``torch.Generator`` seeded ``--seed`` (the inputs from ``--seed + 1``), so a
seed gives the same model on the card and on the CPU. ``--device`` defaults
to ``cuda``; without a card that raises.
"""

from __future__ import annotations

import argparse
import time
from typing import Mapping, NamedTuple

import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import build_model


class ServeResult(NamedTuple):
    ids: torch.Tensor             # (B, gen_len + 1) greedy ids, the prefill's first
    prefill_logits: torch.Tensor  # (B, 1, V_padded) last-position prompt logits
    prefill_s: float              # prefill + first argmax, host clock, synchronized
    decode_s: float               # the decode loop, host clock, synchronized


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prompt_len(batch: Mapping[str, torch.Tensor]) -> int:
    """The prefill's sequence length: frames, or patches + text tokens."""
    if "frames" in batch:
        return batch["frames"].shape[1]
    return batch["tokens"].shape[1] + (batch["patches"].shape[1] if "patches" in batch else 0)


def serve(model, batch: Mapping[str, torch.Tensor], gen_len: int) -> ServeResult:
    """Prefill ``batch`` (``make_batch``'s), then decode ``gen_len`` tokens
    greedily from position ``prompt_len(batch)``."""
    b, p = batch["tokens"].shape[0], prompt_len(batch)
    dev = model.dev
    batch = {k: v.to(dev) for k, v in batch.items()}
    _sync(dev)
    t0 = time.perf_counter()
    prefill_logits = model.prefill(batch)
    out = [torch.argmax(prefill_logits[:, -1], dim=-1)[:, None]]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    cache = model.make_cache(b, p + gen_len)
    t0 = time.perf_counter()
    for i in range(gen_len):
        logits, cache = model.decode_step(cache, out[-1], p + i)
        out.append(torch.argmax(logits[:, -1], dim=-1)[:, None])
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return ServeResult(torch.cat(out, dim=1), prefill_logits, t_prefill, t_decode)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build_model(cfg, args.device).init(torch.Generator().manual_seed(args.seed))

    b, p, g = args.requests, args.prompt_len, args.gen_len
    shape = ShapeConfig("serve", p, b, "prefill")
    batch = model.make_batch(torch.Generator().manual_seed(args.seed + 1), shape)["batch"]

    res = serve(model, batch, g)
    print(f"[serve] prefill {b} x {p} tokens: {res.prefill_s:.3f}s")
    print(f"[serve] decoded {g} tokens x {b} reqs: {res.decode_s:.3f}s "
          f"({b * g / max(res.decode_s, 1e-9):.1f} tok/s)")
    print("[serve] generated ids (first request):", res.ids[0].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

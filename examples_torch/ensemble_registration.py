"""Population-study (ensemble) registration, the paper's motivating clinical
workload: many independent registrations, one Newton step of every pair at
a time (``ensemble_newton_step``); on a mesh the pair axis shards over
every axis that divides it, with no cross-pair collective.

    python examples_torch/ensemble_registration.py [--batch 4]
    python examples_torch/ensemble_registration.py --device cpu --grid 8 --batch 2
"""

import argparse
import time

import _path  # noqa: F401
import torch

from repro_torch import device as D
from repro_torch.core import gauss_newton as GN
from repro_torch.core import transport as T
from repro_torch.data import synthetic
from repro_torch.distributed.claire_dist import ensemble_newton_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--grid", type=int, default=16)
    ap.add_argument("--newton-steps", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = D.resolve(args.device)
    grid = (args.grid,) * 3
    batch = synthetic.make_batch(0, grid, args.batch, amplitude=0.5, device=dev)
    cfg = T.TransportConfig(interp="cubic_bspline", deriv="fd8", nt=4)
    step = ensemble_newton_step(cfg, GN.GNConfig(max_pcg=30))

    v = torch.zeros((args.batch, 3) + grid, dtype=torch.float32, device=dev)
    print(f"ensemble of {args.batch} registrations at {grid}")
    t0 = time.perf_counter()
    for k in range(args.newton_steps):
        stats = step(batch.m0, batch.m1, v, 5e-4, 1e-4, 0.25)
        v = stats.v_new
        mis = stats.j_mismatch.cpu()
        print(f"  GN step {k}: mean J_mismatch = {float(mis.mean()):.4e} "
              f"(per pair: {[f'{float(x):.3e}' for x in mis]})")
    dt = time.perf_counter() - t0
    print(f"\n{args.newton_steps} joint Newton steps over {args.batch} pairs: "
          f"{dt:.1f}s ({dt / args.newton_steps / args.batch:.2f} s/step/pair)")
    print("on the production mesh the pair axis shards over every mesh axis that "
          "divides it (claire_dist.ensemble_shardings): zero cross-pair collectives.")
    return stats


if __name__ == "__main__":
    main()

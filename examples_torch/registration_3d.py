"""End-to-end driver: compare the paper's solver variants on one problem.

The structure of the paper's Table 7 experiment on a synthetic pair:
identical solver settings, three kernel variants (FFT+cubic baseline,
FD8+cubic, FD8+linear), quality metrics per variant.

    python examples_torch/registration_3d.py [--grid 32]
    python examples_torch/registration_3d.py --device cpu --grid 16
"""

import argparse

import _path  # noqa: F401

from repro_torch.core.registration import register
from repro_torch.data import synthetic


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--amplitude", type=float, default=0.5)
    ap.add_argument("--max-newton", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    grid = (args.grid,) * 3
    pair = synthetic.make_pair(1, grid, amplitude=args.amplitude, device=args.device)
    print(f"pair at {grid}; ||m1-m0|| mismatch normalized to 1.0\n")
    print(f"{'variant':14s} {'iters':>5s} {'matvecs':>7s} {'mismatch':>10s} "
          f"{'detF min':>8s} {'detF max':>8s} {'time s':>7s}")
    rows = {}
    for variant in ("fft-cubic", "fd8-cubic", "fd8-linear"):
        res = register(pair.m0, pair.m1, variant=variant, max_newton=args.max_newton,
                       device=args.device)
        rows[variant] = res
        print(f"{variant:14s} {res.iters:5d} {res.matvecs:7d} {res.mismatch_rel:10.3e} "
              f"{res.detF['min']:8.2f} {res.detF['max']:8.2f} {res.wall_time_s:7.1f}")
    return rows


if __name__ == "__main__":
    main()

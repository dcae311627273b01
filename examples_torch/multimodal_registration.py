"""Multi-modal registration: the same anatomy under a different contrast.

A contrast-changed pair (``m1`` is the warped template pushed through an
intensity remap: "inverted" flips bright/dark, "quadratic" adds a nonlinear
stretch) registered with each distance measure. SSD chases intensities it
can never match; NCC (affine intensity invariance) and NGF (edge
alignment) recover the warp. Dice on the modality-independent label masks
is the referee.

    python examples_torch/multimodal_registration.py [--grid 12] [--mode inverted]
    python examples_torch/multimodal_registration.py --device cpu --measures ssd,ncc
"""

import argparse

import _path  # noqa: F401

from repro_torch import api
from repro_torch.data import synthetic


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=12)
    ap.add_argument("--mode", default="inverted", choices=["inverted", "quadratic"])
    ap.add_argument("--measures", default="ssd,ncc,ngf")
    ap.add_argument("--variant", default="fd8-linear")
    ap.add_argument("--max-newton", type=int, default=12)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    grid = (args.grid,) * 3
    pair = synthetic.make_multimodal_pair(args.seed, grid, amplitude=0.6, nt=2,
                                          mode=args.mode, device=args.device)
    problem = api.RegistrationProblem(m0=pair.m0, m1=pair.m1, labels0=pair.labels0,
                                      labels1=pair.labels1, name=f"multimodal-{args.mode}")

    print(f"contrast-{args.mode} pair at {grid} "
          f"(labels are geometric, so Dice is modality-independent)\n")
    rows = []
    for name in args.measures.split(","):
        opts = api.SolverOptions(variant=args.variant, nt=2, max_newton=args.max_newton,
                                 measure=name, device=args.device)
        res = api.solve(problem, opts)
        rows.append((name, res))
        print(f"  {name:4s}: converged={res.converged!s:5s} iters={res.iters:2d} "
              f"dice {float(res.dice_before):.3f} -> {float(res.dice_after):.3f}  "
              f"detF min={res.detF['min']:.3g} ({res.wall_time_s:.1f}s)")

    print("\nmismatch_rel stays the L2 metric (meaningless across modalities); "
          "judge by converged / Dice / detF.")
    best = max(rows, key=lambda r: float(r[1].dice_after))
    print(f"best geometric recovery: {best[0]} (Dice {float(best[1].dice_after):.3f})")
    return rows


if __name__ == "__main__":
    main()

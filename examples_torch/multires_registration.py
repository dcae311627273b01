"""Coarse-to-fine + batched registration through the ``repro_torch.api`` facade.

The same synthetic problem three ways: full-grid single-level,
multi-resolution grid continuation, and a batched pair. Grid continuation
should reach the single-level mismatch with fewer fine-grid Newton
iterations.

    python examples_torch/multires_registration.py [--grid 32]
    python examples_torch/multires_registration.py --device cpu --grid 16
"""

import argparse

import _path  # noqa: F401

from repro_torch import api


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--amplitude", type=float, default=0.5)
    ap.add_argument("--max-newton", type=int, default=20)
    ap.add_argument("--variant", default="fd8-cubic")
    ap.add_argument("--coarse-variant", default=None,
                    help="cheaper variant for coarse levels, e.g. fd8-linear")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    grid = (args.grid,) * 3
    problem = api.RegistrationProblem.synthetic(seed=1, grid=grid, amplitude=args.amplitude,
                                                device=args.device)
    single = api.solve(problem, api.SolverOptions(
        mode="single", variant=args.variant, max_newton=args.max_newton,
        device=args.device))
    print(single.summary())

    multires = api.solve(problem, api.SolverOptions(
        mode="multires", variant=args.variant, max_newton=args.max_newton,
        coarse_variant=args.coarse_variant, device=args.device))
    print(multires.summary())
    for lr in multires.level_results:
        print(f"    level {lr.shape}: iters={lr.iters} matvecs={lr.matvecs} "
              f"|g|rel={lr.rel_grad:.3e} ({lr.wall_time_s:.1f}s)")

    batch_problem = api.RegistrationProblem.synthetic(
        seed=1, grid=grid, amplitude=args.amplitude, batch=2, device=args.device)
    batched = api.solve(batch_problem, api.SolverOptions(
        mode="batch", variant=args.variant, max_newton=args.max_newton,
        device=args.device))
    print(batched.summary())

    saved = single.iters - multires.fine_iters
    print(f"\ngrid continuation saved {saved} fine-grid Newton iteration(s) "
          f"({multires.fine_iters} vs {single.iters}); "
          f"mismatch {multires.mismatch_rel:.3f} vs {single.mismatch_rel:.3f}")
    return single, multires, batched


if __name__ == "__main__":
    main()

"""Registration launcher, the paper's workload (port of
``repro.launch.register``).

    python -m repro_torch.launch.register --config claire_256
    python -m repro_torch.launch.register --grid 32 --variant fft-cubic --device cpu

Generates a synthetic brain-phantom pair at the configured grid size, runs
the Gauss-Newton-Krylov solver and reports the paper's metrics (relative
mismatch, det F, iterations, Hessian matvecs, runtime). ``--device``
(``cuda``, the default, or ``cpu``) takes the place of the JAX launcher's
``--backend``: it raises when ``cuda`` is asked for and there is no card.
"""

from __future__ import annotations

import argparse

from ..configs.registry import REGISTRATIONS, get_registration
from ..core.registration import VARIANTS, register
from ..data import synthetic


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", choices=sorted(REGISTRATIONS), default=None)
    ap.add_argument("--grid", type=int, default=None,
                    help="cubic grid size override (e.g. 32 for CPU runs)")
    ap.add_argument("--variant", choices=sorted(VARIANTS), default="fd8-cubic")
    ap.add_argument("--nt", type=int, default=4)
    ap.add_argument("--max-newton", type=int, default=50)
    ap.add_argument("--beta", type=float, default=5e-4)
    ap.add_argument("--amplitude", type=float, default=0.5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.grid:
        grid = (args.grid,) * 3
    else:
        grid = get_registration(args.config or "claire_64").grid

    print(f"[register] synthesizing pair at {grid} ...")
    pair = synthetic.make_pair(args.seed, grid, amplitude=args.amplitude, nt=args.nt,
                               device=args.device)
    res = register(pair.m0, pair.m1, variant=args.variant, beta=args.beta,
                   nt=args.nt, max_newton=args.max_newton, device=args.device,
                   verbose=args.verbose)
    print(f"[register] variant={args.variant} grid={grid}")
    print(f"  converged={res.converged} iters={res.iters} matvecs={res.matvecs}")
    print(f"  rel mismatch={res.mismatch_rel:.3e} rel grad={res.rel_grad:.3e}")
    print(f"  det F: min={res.detF['min']:.3f} mean={res.detF['mean']:.3f} "
          f"max={res.detF['max']:.3f}")
    print(f"  wall time: {res.wall_time_s:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

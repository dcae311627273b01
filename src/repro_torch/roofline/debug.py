"""Top contributors of one dry-run cell by source site (the dry-run's
"profiler"; the counterpart of ``repro.roofline.debug``, which groups a
module's HLO by its ``op_name`` metadata).

    python -m repro_torch.roofline.debug --arch smollm-135m --shape train_4k [--mesh single] [top_n]
    python -m repro_torch.roofline.debug --claire claire_256_ensemble --claire-mode slab [top_n]

Runs the cell as ``repro_torch.launch.dryrun`` does, with every cost filed
under its site: the innermost frame of the port that issued the op
(``path:line (function)``), the autograd node in backward, and the op or
kernel (``roofline.counts.site``). Prints the top FLOPs, elementwise FLOPs,
memory bytes and collective bytes of one rank. No device is used.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Tuple

from . import counts as RC


def breakdown(by_site: Dict[str, RC.Costs]) -> Tuple[Dict[str, float], ...]:
    """(FLOPs, elementwise FLOPs, memory bytes, collective bytes) by site."""
    return tuple({k: getattr(c, f) for k, c in by_site.items() if getattr(c, f)}
                 for f in ("flops", "ew_flops", "mem_bytes", "coll_bytes"))


def report(by_site: Dict[str, RC.Costs], top_n: int = 15) -> None:
    for title, d, unit in zip(
            ("FLOPs", "elementwise FLOPs", "memory bytes", "collective bytes"),
            breakdown(by_site), ("GFLOP", "GFLOP", "GB", "GB")):
        print(f"\n== top {title} (per device) ==")
        print(f"   total: {sum(d.values()) / 1e9:.2f} {unit}")
        for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top_n]:
            print(f"  {v / 1e9:10.2f} {unit}  {k}")


def main(argv=None) -> int:
    from ..configs import ARCHS, REGISTRATIONS, SHAPES
    from ..launch import dryrun

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--claire", choices=sorted(REGISTRATIONS), default=None)
    ap.add_argument("--claire-mode", choices=("ensemble", "slab"), default="ensemble")
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("top_n", nargs="?", type=int, default=15)
    args = ap.parse_args(argv)
    sites: Dict[str, RC.Costs] = {}
    if args.claire:
        rec = dryrun.run_claire_cell(args.claire, args.claire_mode, args.mesh, sites)
    elif args.arch and args.shape:
        rec = dryrun.run_cell(args.arch, args.shape, args.mesh, sites)
    else:
        ap.error("--arch and --shape required (or --claire)")
    dryrun._record(rec, None)
    report(sites, args.top_n)
    return 0


if __name__ == "__main__":
    sys.exit(main())

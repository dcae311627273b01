"""Readings for a cell's limits: the program on a dozen seeds and the cell's
control on a few, each run like a benchmark run with a short window and
judged the same way, all in one process.

    python3 -m regbench.control --workload claire256-fp32.solve --seeds 12 \\
        --control-seeds 3 --seconds 6 --out chiprun_out/readings.json

The control (``regbench/controls/<cell>.json``) is what the cell would run
in a lower precision than its configuration states: the program's own path
with a configuration key switched (``"solver"``), or the plain reference put
in the program's place and computed with rounded interpolation weights
(``"reference"``). Prints one JSON line per run and, last, each number's
lower reading (the largest of the program's) and upper reading (the
smallest of the control's).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import types
from pathlib import Path

import torch

from . import run as R
from .reference import claire as C
from .reference import judge as J

CONTROLS = Path(__file__).resolve().parent / "controls"


def reference_register(weights: torch.dtype, max_newton: int, max_pcg: int):
    """``register`` of the plain reference with its weights rounded to
    ``weights``, at most ``max_newton`` Newton steps of at most ``max_pcg``
    matvecs, reporting what the program's ``RegistrationResult`` reports."""

    def register(m0, m1, device, **kw):
        pb = dataclasses.replace(J.problem(kw, weights=weights), max_newton=max_newton,
                                 max_pcg=max_pcg)
        m0 = torch.as_tensor(m0).to(device)
        m1 = torch.as_tensor(m1).to(device)
        with torch.no_grad():
            sol = C.solve(m0, m1, pb)
            foot = C.footpoints(sol.v, 1.0 / pb.nt, 1.0, pb.prec)
            warped = C.state(m0, foot, pb.nt, pb.prec)[-1]
            det = C.det_f(sol.v, foot, pb.nt, pb.prec)
        return types.SimpleNamespace(
            v=sol.v, m_warped=warped, mismatch_rel=C.relative_mismatch(warped, m1, m0),
            detF=det, iters=sol.iters, matvecs=sol.matvecs, rel_grad=sol.rel_grad,
            converged=sol.converged, history=[dict(ls_evals=h["ls"]) for h in sol.history])

    return register


def program_of(control: dict) -> dict:
    if control["kind"] == "solver":
        return {"solver": control["solver"]}
    if control["kind"] == "reference":
        return {"register": reference_register(getattr(torch, control["weights"]),
                                               control["max_newton"], control["max_pcg"])}
    raise ValueError(f"unknown control kind {control['kind']!r}")


def suggest(lower: float, upper: float) -> float:
    """A limit between the readings: 60% of the way from the lower to the
    upper on a log scale (more room above the lower, which fresh seeds read
    higher), to one significant digit."""
    lo = math.log10(max(lower, 1e-12))
    x = 10 ** (lo + 0.6 * (math.log10(upper) - lo))
    e = math.floor(math.log10(x))
    return round(x / 10 ** e) * 10 ** e


def readings(workload: str, seeds, control_seeds, seconds: float,
             control_seconds: float, out=None) -> dict:
    control = json.loads((CONTROLS / f"{workload}.json").read_text())
    rows = []
    for kind, seed_list, program, secs in (
            ("program", seeds, None, seconds),
            ("control", control_seeds, program_of(control), control_seconds)):
        for seed in seed_list:
            run, _, _, limits = R.measure(workload, seed, secs, program=program)
            row = dict(kind=kind, seed=seed, checks=run.checks, judged=run.judged,
                       failed=run.failed, answers=len(run.solves) or len(run.requests),
                       correct=run.failed == 0 and run.judged > 0
                       and J.verdict(run.checks, limits))
            rows.append(row)
            print(json.dumps(row), flush=True)
            del run
            torch.cuda.empty_cache()
    lower, upper = {}, {}
    for row in rows:
        side = lower if row["kind"] == "program" else upper
        pick = max if row["kind"] == "program" else min
        for k, x in row["checks"].items():
            side[k] = pick(side.get(k, x), x)
    suggested = {k: suggest(lower[k], upper[k]) for k in lower
                 if k in upper and upper[k] >= 3 * max(lower[k], 1e-12)}
    summary = dict(workload=workload, control=control, lower=lower, upper=upper,
                   suggested=suggested, rows=rows)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(dict(workload=workload, lower=lower, upper=upper, suggested=suggested)),
          flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_100_000_001)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--control-seconds", type=float, default=None,
                    help="the control's window (default: --seconds)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("regbench.control: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(R.ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s0 = args.first_seed
    readings(args.workload, range(s0, s0 + args.seeds),
             range(s0 + 1000, s0 + 1000 + args.control_seeds), args.seconds,
             args.control_seconds or args.seconds, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one benchmark cell once and print its result line.

    python3 -m regbench.run --workload claire256-fp32.solve --seed 7 --seconds 45 --trace 0

From the root of a checkout: finds the cell in ``BENCHMARK.json``, its
configuration in ``regbench/configs/<config>.json`` and its traffic mix in
``regbench/traffic/<mix>.json``, whose ``entry`` names the module of
``regbench/entries/`` that drives the window; makes the mix's problems from
``--seed``, warms up, measures for ``--seconds`` seconds (``--trace 1``:
under the profiler, reporting the cell's per-layer metrics from
``regbench/metrics/<metric>.py``), judges a sample of the window's answers
against the plain reference (``regbench/reference``) with the limits of
``regbench/limits/<cell>.json``, and prints one JSON line last on standard
output, each number compared beside its limit last on standard error.

It measures ``repro_torch`` (``src/``) on the card and nothing else: without
a card, or with fewer cards than the cell asks for, it exits 2 and prints no
result. The CPU rehearsal at a small grid (``main(argv, rehearsal=...)``) is
for the benchmark's own tests and reports no device metric.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names the measured process may not hold
BANNED = ("jax", "jaxlib", "flax", "repro")

# Every build and kernel cache at a fixed place inside the checkout.
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                   ("TRITON_CACHE_DIR", "build/triton"),
                   ("CUDA_CACHE_PATH", "build/nv_compute_cache")):
    os.environ[_var] = str(ROOT / _dir)

import torch  # noqa: E402

from . import generator  # noqa: E402
from . import window as W  # noqa: E402
from .reference import judge as J  # noqa: E402


def _load(folder: str, name: str):
    """The module ``regbench/<folder>/<name>.py``, found by its name."""
    spec = importlib.util.spec_from_file_location(f"regbench.{folder}.{name}",
                                                  HERE / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_reader(name: str):
    return _load("metrics", name).read


def _metric(value, unit):
    return {"value": float(value), "unit": unit}


def end_to_end(run: W.Run, bench: dict) -> dict:
    """The host-clock metrics of the cell, by the names in BENCHMARK.json:
    rates and times per answer over the whole window, which closes when the
    last answer of the work sent in it is in."""
    answered = run.requests
    values = {
        "setup_s": run.setup_s,
        "solve_s": run.window_s / len(run.solves) if run.solves else None,
        "pairs_per_s": len(answered) / run.window_s if answered else None,
        "latency_p90_s": W.percentile([r["latency_s"] for r in answered], 90),
        "peak_gb": run.peak_bytes / 1e9,
    }
    out = {}
    for m in bench["end_to_end"]:
        if run.workload in m.get("workloads", [run.workload]) and values.get(m["name"]) is not None:
            out[m["name"]] = _metric(values[m["name"]], m["unit"])
    return out


def per_layer(run: W.Run, bench: dict) -> dict:
    out = {}
    for m in bench["per_layer"]:
        if run.workload not in m.get("workloads", [run.workload]):
            continue
        value = _load_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = _metric(value, m["unit"])
    return out


def _banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(workload: str, seed: int, seconds: float, traced: bool = False,
            rehearsal: Optional[dict] = None, program: Optional[dict] = None):
    """Make the cell's problems, warm up, measure and judge: the
    :class:`Run`, with the cell's BENCHMARK.json entry and its limits.
    ``program`` replaces what the window drives (controls and faults):
    ``{"solver": {...}}`` overrides configuration keys, ``{"register": fn}``
    the entry of a ``register`` mix. The mix's ``entry`` names the module of
    ``regbench/entries/`` that drives the window. Raises ``KeyError`` for an
    unknown workload."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    config = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    mix = generator.load(cell["traffic"])
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    dev, grid = ("cpu", rehearsal["grid"]) if rehearsal is not None else ("cuda", config["grid"])
    run = W.Run(workload, config, grid, dev, T_START)
    _load("entries", mix["entry"]).drive(run, mix, seed, seconds, traced, config["solver"],
                                          program or {})
    return run, cell, bench, limits


def main(argv=None, rehearsal: Optional[dict] = None, program: Optional[dict] = None) -> int:
    """Run the cell; 0 with the result line printed, else an exit code and
    no result. ``rehearsal`` ({"grid": (n, n, n)}) runs the cell's path on
    the CPU at that grid, without the look for a card, for the benchmark's
    own tests; ``program`` is :func:`measure`'s."""
    args = parse(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"regbench: unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if rehearsal is None and (not torch.cuda.is_available()
                              or torch.cuda.device_count() < chips):
        print(f"regbench: {args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        traceback.print_exc()
        print("regbench: the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run, cell, bench, limits = measure(args.workload, args.seed, args.seconds,
                                       bool(args.trace), rehearsal, program)

    found = _banned_modules()
    if found:
        print(f"regbench: the measured process holds {found}", file=sys.stderr)
        return 4

    correct = run.failed == 0 and run.judged > 0 and J.verdict(run.checks, limits)
    checks = {k: {"value": run.checks.get(k), "limit": lim} for k, lim in limits.items()}
    if rehearsal is not None:
        metrics, device = {}, {"platform": "cpu", "kind": "cpu rehearsal", "count": 0,
                               "memory_peak_bytes": 0}
    else:
        metrics = per_layer(run, bench) if args.trace else end_to_end(run, bench)
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": int(cell["chips"]),
                  "memory_peak_bytes": int(max(run.peak_bytes, run.setup_peak_bytes))}
    line = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if args.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = checks
    print(f"regbench: {args.workload} seed {args.seed}: {len(run.solves) or len(run.requests)} "
          f"answers in {run.window_s:.3f} s, {run.judged} judged, failed {run.failed}",
          file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} <= {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

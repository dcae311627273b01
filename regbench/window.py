"""What a run records and the window's bookkeeping, shared by the entries
(``entries/<entry>.py``) and the per-layer readers (``metrics/``)."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from . import trace


class Run:
    """What one run measured, for the end-to-end metrics and the readers."""

    def __init__(self, workload: str, config: dict, grid, dev: str, t_start: float):
        self.workload = workload
        self.grid = tuple(grid)
        self.nt = int(config["solver"]["nt"])
        self.dev = dev
        self.t_start = t_start            # process start, on the host clock
        self.trace: Optional[trace.Trace] = None
        self.layers = trace.layers()
        self.solves: List[dict] = []      # one per registration of the window
        self.requests: List[dict] = []    # one per request answered in the window
        self.attempted = 0
        self.failed = 0
        self.window_s = 0.0
        self.setup_s = 0.0
        self.peak_bytes = 0
        self.setup_peak_bytes = 0
        self.checks: Dict[str, float] = {}
        self.judged = 0


def sync(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def peak(dev: str) -> int:
    return torch.cuda.max_memory_allocated() if dev == "cuda" else 0


def begin_window(run: Run) -> None:
    """Set-up ends here: its seconds and peak are taken and the peak is reset
    for the window."""
    sync(run.dev)
    run.setup_s = time.perf_counter() - run.t_start
    run.setup_peak_bytes = peak(run.dev)
    if run.dev == "cuda":
        torch.cuda.reset_peak_memory_stats()


def solver_kwargs(solver: dict) -> dict:
    """The ``register`` keywords of a configuration's ``solver`` block."""
    keys = ("variant", "beta", "gamma", "nt", "tol_rel_grad", "max_newton", "measure",
            "mixed_precision", "use_plan", "use_fused_matvec")
    return {k: solver[k] for k in keys}


def percentile(values, q: float) -> Optional[float]:
    """Linear-interpolated percentile, ``q`` in [0, 100]."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    pos = (q / 100.0) * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] * (1.0 - (pos - lo)) + xs[hi] * (pos - lo)

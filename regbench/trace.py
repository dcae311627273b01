"""The traced window: ``torch.profiler`` over the measured window, reduced to
device time by kernel name, the device's busy seconds and its idle gaps.

Device operations are the profiler's CUDA events (kernels, copies, sets).
``busy_s`` is the union of their intervals, ``window_s`` the host-clock
length of the traced window. The harness's own ``record_function`` spans
(``regbench.*``) and the program's operators on the host label the idle
gaps.
"""

from __future__ import annotations

import contextlib
import json
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

LAYERS = Path(__file__).resolve().parent / "layers"


def layers() -> Dict[str, dict]:
    """``layers/<name>/*.json``: each file gives the layer's name and regular
    expressions of kernel names; a layer's kernels are those of all its
    files, so a later change adds a kernel name in a file of its own."""
    out: Dict[str, dict] = {}
    for d in sorted(p for p in LAYERS.iterdir() if p.is_dir()):
        files = [json.loads(f.read_text()) for f in sorted(d.glob("*.json"))]
        out[d.name] = dict(layer=files[0]["layer"],
                           kernels=[k for f in files for k in f["kernels"]])
    return out


class _Result:
    result: "Optional[Trace]" = None


@contextlib.contextmanager
def window(enabled: bool, device: str):
    """Profile the block when ``enabled``; yields a holder whose ``result``
    (a :class:`Trace`, or None) is set when the block ends."""
    holder = _Result()
    if not enabled:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield holder
        if device == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    holder.result = Trace.from_profiler(prof, window_s)


class Trace:
    def __init__(self, device_ops: List[Tuple[str, float, float]],
                 host_ops: List[Tuple[str, float, float]], window_s: float):
        #: (name, start_s, end_s) of every device operation
        self.device_ops = device_ops
        self.host_ops = host_ops
        self.window_s = window_s
        self.by_name: Dict[str, float] = {}
        for name, a, b in device_ops:
            self.by_name[name] = self.by_name.get(name, 0.0) + (b - a)
        self.busy_s, self.gaps = self._busy()

    @classmethod
    def from_profiler(cls, prof, window_s: float) -> "Trace":
        """From the profiler's raw events (building its per-event Python
        objects takes minutes for a window of a few hundred thousand)."""
        from torch.autograd import DeviceType

        dev, host = [], []
        for ev in prof.profiler.kineto_results.events():
            rec = (ev.name(), ev.start_ns() * 1e-9, (ev.start_ns() + ev.duration_ns()) * 1e-9)
            if ev.device_type() == DeviceType.CUDA:
                if not ev.is_user_annotation():
                    dev.append(rec)
            else:
                host.append(rec)
        return cls(dev, host, window_s)

    def _busy(self):
        busy, gaps = 0.0, []
        end = None
        for a, b in sorted((a, b) for _, a, b in self.device_ops):
            if end is None:
                busy, end = b - a, b
            elif a > end:
                gaps.append((end, a))
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy, gaps

    def seconds(self, patterns) -> float:
        """Device seconds of the operations whose names match any pattern."""
        rx = [re.compile(p) for p in patterns]
        return sum(s for n, s in self.by_name.items() if any(r.search(n) for r in rx))

    def matched(self, patterns) -> bool:
        rx = [re.compile(p) for p in patterns]
        return any(r.search(n) for n in self.by_name for r in rx)

    def host_at(self, t: float) -> str:
        """The innermost host operation running at ``t``, or ``idle``."""
        best: Optional[Tuple[float, str]] = None
        for n, a, b in self.host_ops:
            if a <= t <= b and (best is None or a > best[0]):
                best = (a, n)
        return best[1] if best else "idle"

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:10]
        return dict(device_ops=[[n[:120], s] for n, s in ops],
                    idle_gaps=[[self.host_at(a), b - a] for a, b in gaps])

"""Launch counts of the port's kernels.

Each kernel wrapper adds one to its name where it launches its CUDA kernel,
and to ``plain:<name>`` where it takes its plain PyTorch version (only ever
for a tensor on the CPU). A run reads the counts to show which route the
main path took: ``reset()`` just before it, ``snapshot()`` just after.
"""

from __future__ import annotations

import collections
from typing import Dict

_COUNTS: collections.Counter = collections.Counter()


def bump(name: str) -> None:
    _COUNTS[name] += 1


def reset() -> None:
    _COUNTS.clear()


def snapshot() -> Dict[str, int]:
    return dict(_COUNTS)

"""Launch counts of the port's kernels.

Each kernel wrapper adds one to its name where it launches its CUDA kernel,
and to ``plain:<name>`` where it takes its plain PyTorch version (only ever
for a tensor on the CPU). A run reads the counts to show which route the
main path took: ``reset()`` just before it, ``snapshot()`` just after.

A wrapper given a fake tensor (``torch._subclasses.fake_tensor``: shapes
without storage, as the dry-run runs a step) takes a third route, after its
checks and the kernel's own: :func:`fake_launch` adds one to
``fake:<name>``, hands the kernel's name, FLOPs and bytes (inputs read
once, outputs written once) to every listener
(``repro_torch.roofline.counts``), and the wrapper returns an empty output
of the kernel's shape. That route is shape inference: it launches nothing,
computes nothing and leaves the kernel's own count alone.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List

import torch

_COUNTS: collections.Counter = collections.Counter()

#: ``fn(name, flops, nbytes, tensor_core)`` per fake launch
_LISTENERS: List[Callable[[str, float, float, bool], None]] = []


def bump(name: str) -> None:
    _COUNTS[name] += 1


def reset() -> None:
    _COUNTS.clear()


def snapshot() -> Dict[str, int]:
    return dict(_COUNTS)


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (the dry-run's shape inference)."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def fake_launch(name: str, flops: float, nbytes: float, tensor_core: bool = False) -> None:
    """A kernel's launch on fake tensors: counted under ``fake:<name>``, its
    ``flops`` (on the tensor cores or not) and ``nbytes`` handed to the
    listeners."""
    bump("fake:" + name)
    for fn in list(_LISTENERS):
        fn(name, float(flops), float(nbytes), tensor_core)


def add_listener(fn) -> None:
    _LISTENERS.append(fn)


def remove_listener(fn) -> None:
    _LISTENERS.remove(fn)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)

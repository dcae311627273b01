"""Atomic checkpoints of trees of tensors (port of
``repro.checkpoint.checkpoint``).

Layout, the same on disk as the JAX package's, so either package reads what
the other wrote:

    <dir>/step_<N>/
        manifest.json     {"step", "leaves": [{path, file, shape, dtype}]}
        <leaf-path>.npy   one array per leaf

A tree is nested dicts, lists, tuples or NamedTuples whose leaves are
tensors, numpy arrays or scalars (None is an empty subtree). Leaf paths are
JAX's: dict keys in sorted order, list / tuple indices and a NamedTuple's
fields as ``.<name>`` (so a train state's leaves are ``.params.<...>`` and
``.opt.<...>``), joined by ``.``. ``dtype`` is
the numpy name of the logical type; bf16 and fp8, which ``.npy`` cannot
hold, are stored bit-cast to a same-width unsigned integer.

Writes go to a temporary directory first and are renamed into place, so a
preempted writer never leaves a half-written checkpoint visible. Restore
places each leaf on a device chosen at restore time (``device=``), not the
one it was saved from.

``AsyncCheckpointer`` copies the tree to the host on the caller's thread and
writes it on a daemon thread, at most one save in flight.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from .. import device as _device

#: logical dtype name -> (the same-width unsigned type on disk, the torch
#: dtype).
_BITCAST = {
    "bfloat16": (torch.uint16, torch.bfloat16),
    "float8_e4m3fn": (torch.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (torch.uint8, torch.float8_e5m2),
}
_BITCAST_OF = {tdt: name for name, (_, tdt) in _BITCAST.items()}


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """``(leaf path, leaf)`` in JAX's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        # JAX names a NamedTuple's field ".<name>" (its GetAttrKey)
        for name, x in zip(tree._fields, tree):
            yield from _leaves(x, path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, path + (str(i),))
    else:
        yield ".".join(path), tree


def _map(fn: Callable[[str, Any], Any], tree, path: Tuple[str, ...] = ()):
    """``tree`` with each leaf replaced by ``fn(leaf path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map(fn, x, path + (f".{name}",))
                            for name, x in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x, path + (str(i),)) for i, x in enumerate(tree))
    return fn(".".join(path), tree)


def _host(leaf) -> np.ndarray | torch.Tensor:
    """A copy of ``leaf`` on the host: a CPU tensor for a tensor (numpy has
    no bf16 or fp8), else a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _to_disk(leaf) -> Tuple[np.ndarray, str]:
    """The array to ``np.save`` and the logical dtype name of ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype in _BITCAST_OF:
            name = _BITCAST_OF[leaf.dtype]
            return leaf.view(_BITCAST[name][0]).cpu().numpy(), name
        arr = leaf.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    name = str(arr.dtype)
    if name in _BITCAST:   # an ml_dtypes array handed in by a caller
        arr = arr.view(f"uint{8 * arr.itemsize}")
    return arr, name


def _from_disk(arr: np.ndarray, name: str) -> torch.Tensor:
    if name in _BITCAST:
        return torch.from_numpy(arr).view(_BITCAST[name][1])
    return torch.from_numpy(arr)


def save_checkpoint(directory: str, tree: Any, step: int, keep: int = 3) -> str:
    """Synchronous atomic save. Returns the final checkpoint path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=directory))

    manifest = {"step": step, "leaves": []}
    for name, leaf in _leaves(tree):
        arr, logical_dtype = _to_disk(leaf)
        fname = name.replace("/", ".") + ".npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append(
            {"path": name, "file": fname, "shape": list(arr.shape),
             "dtype": logical_dtype})
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc_old(directory, keep)
    return str(final)


def _gc_old(directory: Path, keep: int):
    steps = sorted(
        (p for p in directory.iterdir() if re.match(r"step_\d+$", p.name)),
        key=lambda p: int(p.name.split("_")[1]))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    d = Path(directory)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.iterdir()
             if re.match(r"step_\d+$", p.name)]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, target: Any, step: Optional[int] = None,
                       device=None) -> Any:
    """Restore into the structure of ``target`` (its leaves give the paths
    and the expected shapes). Each leaf comes back as a tensor: on
    ``device`` when it is given, else on the target leaf's device when that
    leaf is a tensor, else on the CPU. A shape that differs from the
    target's raises ``ValueError``, a leaf the checkpoint lacks ``KeyError``.
    """
    dev = _device.resolve(device) if device is not None else None
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    ckpt = Path(directory) / f"step_{step:08d}"
    with open(ckpt / "manifest.json") as f:
        manifest = json.load(f)
    by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}

    def load(name, leaf):
        if name not in by_path:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = np.load(ckpt / by_path[name]["file"])
        expect = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(f"{name}: shape {arr.shape} != expected {expect}")
        out = _from_disk(arr, by_path[name]["dtype"])
        if dev is not None:
            return out.to(dev)
        if isinstance(leaf, torch.Tensor):
            return out.to(leaf.device)
        return out

    return _map(load, target)


class AsyncCheckpointer:
    """Fire-and-forget saves on a daemon thread (one in flight)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, tree: Any, step: int):
        self.wait()
        # A copy on the caller's thread (a consistent snapshot, whatever
        # later writes the caller's tensors or arrays), the I/O async.
        host_tree = _map(lambda _, leaf: _host(leaf), tree)

        def _run():
            self.last_path = save_checkpoint(self.directory, host_tree, step,
                                             keep=self.keep)

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

"""Warm-start cache: per-subject velocity fields with checkpoint persistence
(port of ``repro.serve.cache``).

Longitudinal workloads re-register the same patient repeatedly (follow-up
scans); the velocity of the previous visit is an excellent Gauss-Newton
starting point. The cache stores, per subject,

    v          — the last solved stationary velocity (3, N1, N2, N3)
    gnorm_ref  — the *cold-start* gradient norm of the subject's first solve

``gnorm_ref`` is what makes the warm start honest: the warm iterate's
gradient is already small, so the relative-gradient stopping test must keep
measuring against the cold reference (see ``gauss_newton.solve_batch``) or
the warm solve would chase far more accuracy than the cold one delivered.

Persistence rides ``repro_torch.checkpoint``: each subject is a checkpoint
directory whose step counter is the visit count, so a restarted server
warm-starts from disk and ``keep=`` garbage-collects old visits. The disk
format is the JAX package's, so either package's server reads a cache
directory the other wrote. If a later visit arrives at a different grid,
the cached velocity is spectrally resampled onto the request grid
(``multires.fourier_resample``, on the host), the same transfer the
multi-resolution pyramid uses.

Velocities are held as host numpy arrays that no solve writes: ``update``
copies a tensor it is given, and the asynchronous save copies again before
the write.
"""

from __future__ import annotations

import re
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..checkpoint import (AsyncCheckpointer, latest_step, restore_checkpoint,
                          save_checkpoint)
from ..core import multires as _mr

GridShape = Tuple[int, int, int]


class CacheEntry(NamedTuple):
    v: np.ndarray          # (3, N1, N2, N3) at the entry's native grid
    gnorm_ref: float       # cold-start gradient norm reference
    grid: GridShape
    visits: int            # solves recorded for this subject


class WarmStart(NamedTuple):
    """What :meth:`WarmStartCache.lookup` hands the solver."""
    v0: np.ndarray         # resampled onto the request grid
    gnorm_ref: float
    visits: int


def _subject_dirname(subject: str) -> str:
    """Filesystem-safe subject key (collision-tolerant: serving IDs are
    expected to already be safe; this only guards against separators)."""
    return re.sub(r"[^A-Za-z0-9._-]", "_", subject)


class WarmStartCache:
    """In-memory subject -> velocity map with optional disk persistence.

    ``directory=None`` keeps the cache purely in-memory. With a directory,
    every update is checkpointed (asynchronously by default: saves overlap
    the next device solve) and lookups fall back to disk on a memory miss,
    so a fresh server process resumes the longitudinal history.
    """

    def __init__(self, directory: Optional[str] = None, keep: int = 3,
                 async_io: bool = True):
        self.directory = Path(directory) if directory else None
        self.keep = keep
        self.async_io = async_io and directory is not None
        self._entries: Dict[str, CacheEntry] = {}
        self._ckpt: Dict[str, AsyncCheckpointer] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- lookup ------------------------------------------------------------

    def lookup(self, subject: Optional[str],
               grid: GridShape) -> Optional[WarmStart]:
        if subject is None:
            return None
        with self._lock:
            entry = self._entries.get(subject)
        if entry is None:
            entry = self._load(subject)
            if entry is None:
                return None
            with self._lock:
                self._entries.setdefault(subject, entry)
        v0 = entry.v
        if entry.grid != tuple(grid):
            # cross-resolution follow-up: spectral resample (multires
            # machinery) onto the request grid.
            v0 = _mr.fourier_resample(torch.from_numpy(v0), grid).numpy()
        return WarmStart(v0=v0, gnorm_ref=entry.gnorm_ref,
                         visits=entry.visits)

    # -- update ------------------------------------------------------------

    def update(self, subject: Optional[str], v, gnorm0: float,
               grid: GridShape) -> int:
        """Record a finished solve. Returns the new visit count.

        ``gnorm0`` is the gradient norm at the solve's *starting* iterate;
        it becomes the stopping reference only on the first (cold) visit —
        later visits keep the original cold reference.
        """
        if subject is None:
            return 0
        if isinstance(v, torch.Tensor):
            v = v.detach().to("cpu", torch.float32, copy=True).numpy()
        v = np.asarray(v, dtype=np.float32)
        with self._lock:
            prev = self._entries.get(subject)
            visits = (prev.visits if prev else 0) + 1
            gnorm_ref = prev.gnorm_ref if prev else float(gnorm0)
            entry = CacheEntry(v=v, gnorm_ref=gnorm_ref,
                               grid=tuple(int(n) for n in grid),
                               visits=visits)
            self._entries[subject] = entry
        if self.directory is not None:
            self._persist(subject, entry)
        return visits

    # -- persistence (repro_torch.checkpoint) ------------------------------

    @staticmethod
    def _tree(entry: CacheEntry) -> Dict:
        return {
            "v": entry.v,
            "gnorm_ref": np.float32(entry.gnorm_ref),
            "grid": np.asarray(entry.grid, dtype=np.int32),
        }

    def _persist(self, subject: str, entry: CacheEntry):
        d = str(self.directory / _subject_dirname(subject))
        tree = self._tree(entry)
        if self.async_io:
            ck = self._ckpt.get(subject)
            if ck is None:
                ck = self._ckpt.setdefault(
                    subject, AsyncCheckpointer(d, keep=self.keep))
            ck.save(tree, step=entry.visits)
        else:
            save_checkpoint(d, tree, step=entry.visits, keep=self.keep)

    def _load(self, subject: str) -> Optional[CacheEntry]:
        if self.directory is None:
            return None
        d = self.directory / _subject_dirname(subject)
        step = latest_step(str(d))
        if step is None:
            return None
        # Two-stage restore through the public checkpoint API: the stored
        # grid first (fixed shape), then the velocity at that grid.
        meta = restore_checkpoint(str(d), {"grid": np.zeros(3, np.int32)},
                                  step=step)
        grid = tuple(int(n) for n in meta["grid"].tolist())
        full = restore_checkpoint(
            str(d),
            {"v": np.zeros((3,) + grid, np.float32),
             "gnorm_ref": np.float32(0)},
            step=step)
        return CacheEntry(v=full["v"].numpy(),
                          gnorm_ref=float(full["gnorm_ref"]),
                          grid=grid, visits=step)

    def flush(self):
        """Block until all in-flight async saves hit disk."""
        for ck in list(self._ckpt.values()):
            ck.wait()

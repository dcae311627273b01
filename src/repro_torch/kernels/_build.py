"""Build the port's CUDA sources with ``nvcc`` and bind them through ``ctypes``.

Every ``csrc/*.cu`` file has a plain C interface (pointers, sizes and the
stream as arguments, ``cudaGetLastError()`` as the return value) and compiles
on its own into ``build/kernels/<digest>/lib<name>.so`` at the repository
root, at first use::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

``<digest>`` hashes every source and the flags, so an edited source rebuilds
and an unchanged one loads at once. All sources compile in parallel, one
``nvcc`` process each. Nothing here runs at import: the CPU tests import every
module of the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name -> loaded library (one per source, loaded once per process).
_LIBS: Dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": wall seconds of its nvcc, "ptxas": [ptxas info lines]}
#: for the sources this process compiled (empty when all were cached).
BUILD_LOG: Dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels of repro_torch cannot be built")
    return path


def sources():
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source that is not built yet, all at once; return the
    directory that holds the libraries. Raises with nvcc's output on failure."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sources():
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
        proc = subprocess.Popen([_nvcc(), *FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[src.stem] = (proc, tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        # Atomic rename: a concurrent builder of the same digest sees either
        # no library or a whole one.
        os.replace(tmp, lib)
        BUILD_LOG[name] = dict(
            seconds=time.perf_counter() - t0,
            ptxas=[ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln or "Compiling entry" in ln])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out_dir


def library(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """Load ``lib<name>.so`` (building every source first if needed) and
    declare ``signatures``: C function name -> tuple of ctypes argument
    types; every function returns an ``int`` CUDA error code."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (refused launches never
    run, and a later synchronize would not report them)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {rc}")

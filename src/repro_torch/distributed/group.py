"""Process groups for the slab-parallel solve (the counterpart of the mesh
helpers the JAX slab code takes from ``repro.launch.mesh``).

A slab solve runs one process per rank, each on its own card (``cuda``,
NCCL) or on the CPU (``cpu``, gloo). Nothing here reads a cluster: the
caller names the rendezvous (``tcp://localhost:<port>`` or
``file://<path>``), the world size and the rank. A ``cuda`` group without
NCCL raises; there is no fallback to gloo.

``ensemble_slab_groups`` splits the world into the two groups of the
ensemble x slab mode, the counterpart of the JAX package's
``make_mesh((E, S), ("ensemble", "slab"))``. ``run_ranks`` runs a function
on P CPU ranks in fresh processes, for tests and rehearsals without a card.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time
from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: Seconds a collective may wait for its peers before it raises.
DEFAULT_TIMEOUT_S = 300


def init_slab_group(rank: int, world_size: int, init_method: str, device="cuda",
                    timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the default process group as ``rank`` of ``world_size``: NCCL on
    ``cuda`` (the rank's card is ``LOCAL_RANK``, else the rank modulo the
    card count, and becomes the current device), gloo on ``cpu``. Returns
    the group (``dist.group.WORLD``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_slab_group(device='cuda'): torch sees no CUDA device")
        if not dist.is_nccl_available():
            raise RuntimeError("init_slab_group(device='cuda') needs NCCL, which this "
                               "torch lacks; a cuda slab solve does not run on gloo")
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    elif dev.type == "cpu":
        if not dist.is_gloo_available():
            raise RuntimeError("init_slab_group(device='cpu') needs gloo, which this "
                               "torch lacks")
        backend = "gloo"
    else:
        raise ValueError(f"slab groups run on 'cuda' or 'cpu', got {device!r}")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


@dataclasses.dataclass(frozen=True)
class EnsembleSlabGroups:
    """The two groups of one rank in a world of ``E * S`` ranks laid out as
    an (ensemble, slab) grid: rank ``r = e * S + s``. ``slab`` holds the
    ranks with this rank's ``e`` (they share one pair's grid, in x1 slabs),
    ``ensemble`` the ranks with this rank's ``s`` (they hold the same slab of
    different pairs)."""

    ensemble: object
    slab: object
    ensemble_size: int
    slab_size: int

    def sizes(self) -> Dict[str, int]:
        return {"ensemble": self.ensemble_size, "slab": self.slab_size}


def ensemble_slab_groups(ensemble_size: int, slab_size: int) -> EnsembleSlabGroups:
    """Split the initialised default group (``ensemble_size * slab_size``
    ranks) into this rank's ensemble and slab groups. Every rank must call it,
    in the same order as its other ``new_group`` calls: it creates every
    slab group, then every ensemble group."""
    e_n, s_n = int(ensemble_size), int(slab_size)
    world = dist.get_world_size()
    if e_n < 1 or s_n < 1 or e_n * s_n != world:
        raise ValueError(f"an ensemble x slab layout of {e_n} x {s_n} needs {e_n * s_n} "
                         f"ranks, the group has {world}")
    e, s = divmod(dist.get_rank(), s_n)
    slabs = [dist.new_group([ei * s_n + si for si in range(s_n)]) for ei in range(e_n)]
    ensembles = [dist.new_group([ei * s_n + si for ei in range(e_n)]) for si in range(s_n)]
    return EnsembleSlabGroups(ensemble=ensembles[s], slab=slabs[e], ensemble_size=e_n,
                              slab_size=s_n)


def _rank_main(rank: int, fn: Callable, nprocs: int, args: Sequence, init: str,
               out_dir: str, timeout_s: float) -> None:
    torch.set_num_threads(1)
    init_slab_group(rank, nprocs, init, "cpu", timeout_s=timeout_s)
    try:
        out = fn(rank, nprocs, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        # no rank tears its connections down while a peer still uses them
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, nprocs: int, args: Sequence = (),
              timeout_s: float = DEFAULT_TIMEOUT_S) -> List:
    """Run ``fn(rank, nprocs, *args)`` on ``nprocs`` gloo ranks, each a fresh
    process (``spawn``) with one torch thread, joined through a ``file://``
    store in a temporary directory; return the ranks' return
    values in rank order. ``fn`` must be importable by name (defined at a
    module's top level) and return something ``torch.save`` takes. Raises
    if a rank raises, and kills every rank and raises ``TimeoutError`` after
    ``timeout_s`` seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, nprocs, tuple(args), init, tmp, timeout_s),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks still running after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(nprocs)]

"""Meshes of the port (counterpart of ``repro.launch.mesh``).

A :class:`Mesh` names its axes and their sizes as a JAX mesh does
(``axis_names``; ``shape``, a dict from name to size), so the sharding rules
of ``repro_torch.distributed.sharding`` read either. A mesh is *abstract*
when it has no ranks: the production meshes, and any mesh built before a
process group exists. A mesh built inside a ``torch.distributed`` world of
exactly its size is backed by a ``DeviceMesh``, with one process group per
axis (NCCL on ``cuda``, gloo on ``cpu``; the world's own backend, never a
fallback from one to the other).

  single pod : (data=16, model=16)          = 256 cards
  multi pod  : (pod=2, data=16, model=16)   = 512 cards

``pod`` is data parallelism across the pods' boundary; ``data`` is data
parallelism inside a pod; ``model`` carries the parameter shards.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: the backend a mesh of each device type runs on
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

#: the axes of a mesh given as a shape alone (``--mesh-shape d,m``), as in
#: JAX's launcher: ``SHAPE_AXES[:len(shape)]``; ``pod`` only from a
#: production mesh
SHAPE_AXES = ("data", "model")


class Mesh:
    """Axis names and sizes, and the ``DeviceMesh`` behind them (None when
    the mesh is abstract)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], device_mesh=None):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"a mesh needs one distinct name per axis: shape {shape}, "
                             f"axes {axes}")
        self.axis_names: Tuple[str, ...] = axes
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def abstract(self) -> bool:
        return self.device_mesh is None

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self) -> str:
        kind = "abstract" if self.abstract else self.device_mesh.device_type
        return f"Mesh({self.shape}, {kind})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The (16, 16) or (2, 16, 16) production mesh, abstract."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``: abstract when no process group is
    initialised, else backed by ``init_device_mesh`` over the world, which
    must have exactly ``prod(shape)`` ranks (``ValueError`` naming both
    sizes). ``device`` ("cuda" or "cpu") defaults to the world's backend's;
    one that does not match the backend raises."""
    mesh = Mesh(shape, axes)
    if not dist.is_initialized():
        return mesh
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"a {tuple(shape)} mesh over {tuple(axes)} needs {mesh.size} "
                         f"ranks, the process group has {world}")
    backend = dist.get_backend()
    dev_type = (torch.device(device).type if device is not None else
                "cuda" if backend == "nccl" else "cpu")
    if _BACKENDS.get(dev_type) != backend:
        raise RuntimeError(f"a {dev_type} mesh runs on {_BACKENDS.get(dev_type)}, the "
                           f"process group runs {backend}")
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev_type, tuple(mesh.shape.values()), mesh_dim_names=mesh.axis_names)
    return Mesh(mesh.shape.values(), mesh.axis_names, dm)


def dp_axis_names(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of a mesh ((pod, data) when pod exists)."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis_name(mesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    out = 1
    for n in names:
        if n in mesh.axis_names:
            out *= mesh.shape[n]
    return out

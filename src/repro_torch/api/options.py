"""Solver options for the registration facade (port of ``repro.api.options``).

One flat, JSON-serializable record of every knob the facade exposes: the
paper's Table 6 variant, the Gauss-Newton and regularization parameters and
the multi-resolution schedule. ``mode="auto"`` picks batched solving for
batched problems and multi-resolution for grids large enough to coarsen.

Against the JAX options: ``backend`` becomes ``device`` (``"cuda"``, the
default, or ``"cpu"``, as in ``register``), and ``mesh`` is a
``torch.distributed`` slab group or a ``group.EnsembleSlabGroups`` layout,
which also name the axes, so ``slab_axis`` and ``ensemble_axis`` are gone.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core import measures as _meas
from ..core import registration as _reg
from ..distributed import group as _group

MODES = ("auto", "single", "multires", "batch")


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """JSON-safe record of a group layout (axis -> size), shared by options
    and results: ``{"ensemble": E, "slab": S}`` for an ensemble x slab
    layout, ``{"slab": P}`` for a slab group."""
    if isinstance(mesh, _group.EnsembleSlabGroups):
        return mesh.sizes()
    return {"slab": int(dist.get_world_size(mesh))}


@dataclass(frozen=True)
class SolverOptions:
    # kernel variant (Table 6) and transport discretization
    variant: str = "fd8-cubic"
    nt: int = 4
    device: object = "cuda"
    mixed_precision: bool = False
    # each PCG matvec's SL gather + RK2 epilogue in one kernel (K3);
    # requires use_plan
    use_fused_matvec: bool = False
    # build-once/apply-many interpolation plans; False selects the plan-free
    # path (K4 at the footpoints in every step)
    use_plan: bool = True
    # distance measure: "ssd" | "ncc" | "ngf", or a
    # repro_torch.core.measures.DistanceMeasure instance; Result.mismatch_rel
    # stays the L2 metric whatever the measure
    measure: object = "ssd"
    # objective / Gauss-Newton
    beta: float = 5e-4
    gamma: float = 1e-4
    tol_rel_grad: float = 5e-2
    max_newton: int = 50
    continuation: bool = False
    # warm start: initial velocity (3, N1, N2, N3), or (B, 3, ...) for
    # batched problems; ``gnorm_ref`` fixes the stopping test's reference
    # (per pair for batched problems)
    v0: object = None
    gnorm_ref: object = None
    # solve strategy
    mode: str = "auto"
    # slab-parallel solving (repro_torch.distributed): a torch.distributed
    # slab group, or an EnsembleSlabGroups layout for batched problems.
    # None = one device. ``halo`` is the SL interpolation halo in voxels.
    mesh: object = None
    halo: int = 6
    # "none" | "int8": absmax int8 halo payloads
    halo_compression: str = "none"
    # multi-resolution schedule (mode "multires" or "auto")
    levels: Optional[Sequence[Tuple[int, int, int]]] = None
    n_levels: Optional[int] = None
    min_size: int = 8
    coarse_tol: Optional[float] = None
    level_newton: Optional[Sequence[int]] = None
    coarse_variant: Optional[str] = None
    presmooth_sigma: float = 0.0
    verbose: bool = False

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.variant not in _reg.VARIANTS:
            raise ValueError(
                f"unknown variant {self.variant!r}; choose from {sorted(_reg.VARIANTS)}")
        if self.coarse_variant is not None and self.coarse_variant not in _reg.VARIANTS:
            raise ValueError(f"unknown coarse_variant {self.coarse_variant!r}")
        _meas.resolve(self.measure)  # raises on unknown measure specs
        if torch.device(self.device).type not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {self.device!r}")
        if self.halo_compression not in ("none", "int8"):
            raise ValueError(f"halo_compression must be 'none' or 'int8', "
                             f"got {self.halo_compression!r}")
        if self.use_fused_matvec and not self.use_plan:
            raise ValueError("use_fused_matvec requires use_plan=True")

    def resolve_mode(self, is_batched: bool, grid: Tuple[int, int, int]) -> str:
        """Concrete solve strategy for a problem of the given shape."""
        if self.mode != "auto":
            if self.mode == "batch" and not is_batched:
                raise ValueError("mode='batch' requires a batched problem")
            if is_batched and self.mode != "batch":
                raise ValueError(
                    f"batched problem requires mode 'batch' or 'auto', got {self.mode!r}")
            return self.mode
        if is_batched:
            return "batch"
        if min(grid) >= 2 * self.min_size:
            return "multires"
        return "single"

    def to_dict(self) -> Dict:
        # Groups, measure instances and warm-start tensors do not serialize:
        # record the layout's sizes, the measure's name and the shapes.
        d = asdict(replace(self, mesh=None, v0=None, gnorm_ref=None, measure=None))
        d["device"] = str(self.device)
        d["measure"] = _meas.resolve(self.measure).name
        if self.v0 is not None:
            d["v0"] = list(getattr(self.v0, "shape", ()))
        if self.gnorm_ref is not None:
            d["gnorm_ref"] = (list(self.gnorm_ref.shape) if hasattr(self.gnorm_ref, "shape")
                              else float(self.gnorm_ref))
        if d["levels"] is not None:
            d["levels"] = [list(s) for s in d["levels"]]
        if d["level_newton"] is not None:
            d["level_newton"] = list(d["level_newton"])
        if self.mesh is not None:
            d["mesh"] = mesh_axis_sizes(self.mesh)
        return d

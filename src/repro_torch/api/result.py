"""Result record of the registration facade (port of ``repro.api.result``).

Wraps the core solver outputs (single / multires / batch) in one shape with
a JSON-safe ``to_dict()``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch


@dataclass(frozen=True)
class Result:
    """Outcome of :meth:`repro_torch.api.Solver.solve`.

    Scalar fields hold per-pair lists when the problem was batched
    (``batch is not None``); ``fine_iters``/``levels``/``level_results`` are
    set only for multi-resolution solves.
    """

    mode: str
    grid: Tuple[int, int, int]
    v: torch.Tensor
    m_warped: torch.Tensor
    mismatch_rel: Any               # float | List[float]
    detF: Any                       # dict | List[dict]
    iters: Any                      # int | List[int]
    matvecs: Any
    rel_grad: Any
    converged: Any
    wall_time_s: float
    batch: Optional[int] = None
    levels: Optional[List[Tuple[int, int, int]]] = None
    fine_iters: Optional[int] = None
    level_results: Optional[list] = None
    dice_before: Optional[Any] = None
    dice_after: Optional[Any] = None
    # slab-parallel solves: group axis -> size (None on one device)
    mesh: Optional[Dict[str, int]] = None

    def to_dict(self) -> Dict:
        """JSON-serializable summary (tensors and per-iteration logs left out)."""
        d: Dict[str, Any] = dict(
            mode=self.mode,
            grid=list(self.grid),
            mismatch_rel=self.mismatch_rel,
            detF=self.detF,
            iters=self.iters,
            matvecs=self.matvecs,
            rel_grad=self.rel_grad,
            converged=self.converged,
            wall_time_s=self.wall_time_s,
        )
        if self.batch is not None:
            d["batch"] = self.batch
        if self.levels is not None:
            d["levels"] = [list(s) for s in self.levels]
        if self.fine_iters is not None:
            d["fine_iters"] = self.fine_iters
        if self.dice_before is not None:
            d["dice_before"] = self.dice_before
            d["dice_after"] = self.dice_after
        if self.mesh is not None:
            d["mesh"] = dict(self.mesh)
        return d

    def summary(self) -> str:
        g = "x".join(map(str, self.grid))
        if self.batch is not None:
            mis = ", ".join(f"{m:.3f}" for m in self.mismatch_rel)
            return (f"[{self.mode}] {g} B={self.batch}: mismatch [{mis}] "
                    f"iters {self.iters} in {self.wall_time_s:.1f}s")
        extra = f" fine_iters {self.fine_iters}" if self.fine_iters is not None else ""
        return (f"[{self.mode}] {g}: mismatch {self.mismatch_rel:.3f} "
                f"iters {self.iters}{extra} matvecs {self.matvecs} "
                f"in {self.wall_time_s:.1f}s")

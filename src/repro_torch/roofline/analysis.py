"""Three-term roofline model for the NVIDIA H100 SXM (port of
``repro.roofline.analysis``, whose constants are a TPU v5e's).

    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = bytes_per_device / HBM_bw
    collective term = collective_bytes_per_device / link_bw

Only generic roofline math lives here: per-kernel bounds
(:func:`kernel_roofline`) and the three-term step model
(:func:`roofline_terms`). The LM's useful-FLOPs accounting (``model_flops``)
is in :mod:`repro_torch.roofline.lm`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

#: NVIDIA H100 SXM per-card peaks, from NVIDIA's H100 Tensor Core GPU data
#: sheet (SXM column, dense rates without sparsity, at the 700 W limit).
HW = dict(
    peak_flops=989e12,       # bf16 / fp16 tensor-core FLOP/s
    peak_fp32_flops=67e12,   # fp32 FLOP/s outside the tensor cores
    hbm_bw=3.35e12,          # HBM3 B/s
    link_bw=450e9,           # NVLink 4: 900 GB/s a card in both directions, per direction
)
#: the H100 SXM's HBM3 capacity (80 GB), the dry-run's memory limit
HBM_BYTES = 80e9


@dataclass
class RooflineResult:
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str
    hlo_flops_device: float
    hlo_bytes_device: float
    collective_bytes_device: float
    model_flops_global: float
    useful_ratio: float
    step_s: float                 # max of the three terms (no-overlap bound)
    roofline_fraction: float      # model-flops-time / step time


@dataclass
class KernelRoofline:
    """Roofline time bound of one kernel or program from its costs."""

    flops: float
    mem_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    roofline_s: float       # max of the three terms (no-overlap lower bound)
    bound: str              # "compute" | "memory" | "collective"
    intensity: float        # FLOP per HBM byte


def kernel_roofline(
    flops: float,
    mem_bytes: float,
    collective_bytes: float = 0.0,
    hw: Optional[Dict[str, float]] = None,
) -> KernelRoofline:
    """Per-kernel roofline bound: whichever of compute / HBM / interconnect
    takes longest is the floor on the kernel's runtime. ``hw`` overrides the
    H100 constants (e.g. ``peak_flops=HW["peak_fp32_flops"]`` for fp32 work
    outside the tensor cores)."""
    hw = HW if hw is None else hw
    t_c = flops / hw["peak_flops"]
    t_m = mem_bytes / hw["hbm_bw"]
    t_x = collective_bytes / hw["link_bw"]
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bound = max(terms, key=terms.get)
    return KernelRoofline(
        flops=flops,
        mem_bytes=mem_bytes,
        collective_bytes=collective_bytes,
        compute_s=t_c,
        memory_s=t_m,
        collective_s=t_x,
        roofline_s=max(t_c, t_m, t_x),
        bound=bound,
        intensity=(flops / mem_bytes) if mem_bytes > 0 else 0.0,
    )


def achieved_fraction(roofline_s: float, measured_s: float) -> float:
    """Fraction of the roofline bound a measured runtime achieves (<= 1 when
    the model holds; > 1 flags a mis-modeled kernel or wrong HW constants)."""
    return roofline_s / measured_s if measured_s > 0 else 0.0


def roofline_terms(
    hlo_flops_device: float,
    hlo_bytes_device: float,
    collective_bytes_device: float,
    chips: int,
    model_flops_global: float = 0.0,
) -> RooflineResult:
    """The three terms of one step from its per-device costs (the field
    names keep JAX's ``hlo_*``; the port counts from shapes)."""
    t_c = hlo_flops_device / HW["peak_flops"]
    t_m = hlo_bytes_device / HW["hbm_bw"]
    t_x = collective_bytes_device / HW["link_bw"]
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bound = max(terms, key=terms.get)
    step = max(t_c, t_m, t_x)
    useful = (model_flops_global / (hlo_flops_device * chips)
              if hlo_flops_device > 0 else 0.0)
    # "roofline fraction": the share of the step bound that is irreducible
    # useful compute, how close the cell is to the compute roofline.
    t_useful = (model_flops_global / chips) / HW["peak_flops"]
    frac = t_useful / step if step > 0 else 0.0
    return RooflineResult(
        compute_s=t_c,
        memory_s=t_m,
        collective_s=t_x,
        bound=bound,
        hlo_flops_device=hlo_flops_device,
        hlo_bytes_device=hlo_bytes_device,
        collective_bytes_device=collective_bytes_device,
        model_flops_global=model_flops_global,
        useful_ratio=useful,
        step_s=step,
        roofline_fraction=frac,
    )

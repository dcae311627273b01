"""Plan gather (kernel K2) and fused plan gather + matvec epilogue (K3).

Ports of ``repro.kernels.interp3d.interp3d.apply_plan_pallas`` and
``apply_plan_fused``. Both wrappers dispatch on the device of the
coefficients: a CPU tensor takes the plain PyTorch version beside the
wrapper, a CUDA tensor launches ``csrc/interp3d.cu`` (or raises).

A plan (``repro_torch.core.interp.InterpPlan``) holds ``idx``: three int32
tensors ``(S, *out_shape)`` of per-axis flat-index contributions (periodic
wrap and strides baked in) and ``weights``: three ``(S, *out_shape)`` weight
tensors. The kernels take fp32 weights only; bf16 weights are queued
(ROADMAP A11).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import counts

#: epilogue name -> (selector passed to the kernel, plain PyTorch version).
#: The two pointwise RK2 updates of ``repro.core.hessian._matvec_fused``.
EPILOGUES = {
    "inc_state": (0, lambda a0, a1, e, dt: a0 + 0.5 * dt * (a1 + e)),
    "inc_adjoint": (1, lambda a0, a1, e, dt:
                    a0 + 0.5 * dt * (a1 + e * (a0 + dt * a1))),
}

_P = ctypes.c_void_p
_SIGNATURES = {
    "apply_plan_f32": (_P, _P, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, _P, _P, _P, _P, _P, _P,
                       _P),
    "apply_plan_fused_f32": (_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                             ctypes.c_int, _P, _P, _P, _P, _P, _P,
                             ctypes.c_int, ctypes.c_float, ctypes.c_float, _P),
}


def _check_plan(coef: torch.Tensor, plan) -> None:
    if tuple(coef.shape[-3:]) != tuple(plan.field_shape):
        raise ValueError(f"field shape {tuple(coef.shape[-3:])} != plan field "
                         f"shape {tuple(plan.field_shape)}")


def apply_plan_plain(coef: torch.Tensor, plan) -> torch.Tensor:
    """Plain version of K2: ``coef`` ``(..., N1, N2, N3)`` through ``plan``,
    fp32 accumulation, same tap order as ``repro.core.interp.apply_plan``."""
    _check_plan(coef, plan)
    support = plan.support
    i1, i2, i3 = (i.long() for i in plan.idx)
    w1, w2, w3 = plan.weights
    lead = tuple(coef.shape[:-3])
    out_shape = tuple(plan.out_shape)
    f_flat = coef.reshape(lead + (-1,))
    acc = torch.zeros(lead + out_shape, dtype=torch.float32, device=coef.device)
    for a in range(support):
        ia = i1[a]
        for b in range(support):
            iab = ia + i2[b]
            wab = w1[a] * w2[b]
            for c in range(support):
                idx = (iab + i3[c]).reshape(-1)
                vals = f_flat.index_select(-1, idx).reshape(lead + out_shape)
                acc = acc + (wab * w3[c] * vals).to(torch.float32)
    return acc


def _plan_args(plan, device):
    for t in plan.idx:
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != device:
            raise ValueError("plan indices must be contiguous int32 on the "
                             "coefficients' device")
    for t in plan.weights:
        if t.dtype == torch.bfloat16:
            raise NotImplementedError(
                "bf16 interpolation weights on the card are not ported yet "
                "(ROADMAP A11)")
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
            raise ValueError("plan weights must be contiguous float32 on the "
                             "coefficients' device")
    if plan.support not in (2, 4):
        raise ValueError(f"plan support {plan.support} not in (2, 4)")
    return [t.data_ptr() for t in plan.idx] + [t.data_ptr() for t in plan.weights]


def _check_cuda_coef(coef: torch.Tensor, what: str) -> None:
    if coef.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {coef.device}")
    if coef.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes float32 coefficients, got {coef.dtype}")
    if not coef.is_contiguous():
        raise ValueError(f"{what} kernel needs contiguous coefficients")


def apply_plan(coef: torch.Tensor, plan) -> torch.Tensor:
    """K2: evaluate ``coef`` ``(..., N1, N2, N3)`` through ``plan``; returns
    ``coef.shape[:-3] + plan.out_shape`` in float32."""
    _check_plan(coef, plan)
    if coef.device.type == "cpu":
        counts.bump("plain:apply_plan")
        return apply_plan_plain(coef, plan)
    _check_cuda_coef(coef, "apply_plan")
    ptrs = _plan_args(plan, coef.device)
    lead = tuple(coef.shape[:-3])
    out_shape = tuple(plan.out_shape)
    nfields = math.prod(lead)
    out = torch.empty(lead + out_shape, dtype=torch.float32, device=coef.device)
    lib = _build.library("interp3d", _SIGNATURES)
    rc = lib.apply_plan_f32(
        coef.data_ptr(), out.data_ptr(), nfields, math.prod(plan.field_shape),
        math.prod(out_shape), plan.support, *ptrs,
        torch.cuda.current_stream(coef.device).cuda_stream)
    _build.check(rc, "apply_plan")
    counts.bump("apply_plan")
    return out


def apply_plan_fused_plain(coefs: torch.Tensor, plan, extra: torch.Tensor,
                           epilogue: str, dt: float) -> torch.Tensor:
    """Plain version of K3: gather the two stacked fields, then the epilogue."""
    acc = apply_plan_plain(coefs, plan)
    return EPILOGUES[epilogue][1](acc[0], acc[1], extra, dt)


def apply_plan_fused(coefs: torch.Tensor, plan, extra: torch.Tensor,
                     epilogue: str, dt: float) -> torch.Tensor:
    """K3: gather ``coefs`` ``(2, N1, N2, N3)`` through ``plan`` and apply the
    epilogue ``"inc_state"`` or ``"inc_adjoint"`` with the pointwise
    ``extra`` field (plan output shape) and time step ``dt``."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; expected one of "
                         f"{sorted(EPILOGUES)}")
    if coefs.dim() != 4 or coefs.shape[0] != 2:
        raise ValueError(f"expected stacked coefficients (2, N1, N2, N3), got "
                         f"{tuple(coefs.shape)}")
    _check_plan(coefs, plan)
    out_shape = tuple(plan.out_shape)
    if tuple(extra.shape) != out_shape:
        raise ValueError(f"extra field shape {tuple(extra.shape)} != plan output "
                         f"shape {out_shape}")
    if coefs.device.type == "cpu":
        counts.bump("plain:apply_plan_fused:" + epilogue)
        return apply_plan_fused_plain(coefs, plan, extra, epilogue, dt)
    _check_cuda_coef(coefs, "apply_plan_fused")
    if (extra.dtype != torch.float32 or not extra.is_contiguous()
            or extra.device != coefs.device):
        raise ValueError("extra field must be contiguous float32 on the "
                         "coefficients' device")
    ptrs = _plan_args(plan, coefs.device)
    out = torch.empty(out_shape, dtype=torch.float32, device=coefs.device)
    lib = _build.library("interp3d", _SIGNATURES)
    rc = lib.apply_plan_fused_f32(
        coefs.data_ptr(), extra.data_ptr(), out.data_ptr(),
        math.prod(plan.field_shape), math.prod(out_shape), plan.support, *ptrs,
        EPILOGUES[epilogue][0], float(0.5 * dt), float(dt),
        torch.cuda.current_stream(coefs.device).cuda_stream)
    _build.check(rc, "apply_plan_fused")
    counts.bump("apply_plan_fused:" + epilogue)
    return out

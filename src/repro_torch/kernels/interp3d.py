"""Tensor-product interpolation kernels: plan gather (K2), fused plan gather
+ matvec epilogue (K3) and plan-free interpolation at query points (K4).

Ports of ``repro.kernels.interp3d.interp3d.apply_plan_pallas``,
``apply_plan_fused`` and ``interp3d_pallas``. Every wrapper dispatches on the
device of the coefficients: a CPU tensor takes the plain PyTorch version
beside the wrapper, a CUDA tensor launches ``csrc/interp3d.cu`` (or raises).

A plan (``repro_torch.core.interp.InterpPlan``) holds ``idx``: three int32
tensors ``(S, *out_shape)`` of per-axis flat-index contributions (periodic
wrap and strides baked in) and ``weights``: three ``(S, *out_shape)`` weight
tensors, float32 or bfloat16 (mixed precision).

Mixed precision follows the JAX solver as XLA compiles it (jit): only the
weights are bf16, the fields stay fp32 and accumulation is fp32. Per tap
``wab = bf16(w1 * w2)`` is rounded to bf16, while ``wab * w3`` stays in
fp32 (XLA keeps the excess precision) before it multiplies the field value.

A weight's bf16 rounding depends on its last fp32 bit, so weights that are
rounded to bf16 come from the arithmetic XLA compiles: ``x / 6`` becomes
``x * fp32(1/6)``, and a multiply-add is contracted into an FMA where the
product has a single use. That depends on the fusion: JAX's ``build_plan``
computes each weight in a fusion of its own (every B-spline multiply-add
contracts, ``plan_weights``); ``interp_field`` computes all four in one
fusion that shares 3t, 3t², t³ and 3t³ (only 6t² contracts,
``query_weights``, which K4 uses for both weight dtypes). fp32 plan weights
keep the formulas as the source reads them, an ulp away.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple

import numpy as np
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

# ---------------------------------------------------------------------------
# Basis weights (the polynomials of ``repro.core.interp``)
# ---------------------------------------------------------------------------


def lagrange_weights(t: torch.Tensor):
    """Cubic Lagrange basis at nodes {-1, 0, 1, 2} evaluated at t in [0,1)."""
    w0 = -t * (t - 1.0) * (t - 2.0) / 6.0
    w1 = (t + 1.0) * (t - 1.0) * (t - 2.0) / 2.0
    w2 = -(t + 1.0) * t * (t - 2.0) / 2.0
    w3 = (t + 1.0) * t * (t - 1.0) / 6.0
    return (w0, w1, w2, w3)


def bspline_weights(t: torch.Tensor):
    """Uniform cubic B-spline basis at offsets {-1, 0, 1, 2} for t in [0,1)."""
    t2 = t * t
    t3 = t2 * t
    w0 = (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0
    w1 = (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0
    w2 = (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0
    w3 = t3 / 6.0
    return (w0, w1, w2, w3)


def linear_weights(t: torch.Tensor):
    return (1.0 - t, t)


#: fp32(1/6): XLA rewrites a division by the constant 6 as this product.
_SIXTH = float(np.float32(1.0 / 6.0))


def _fma(a, b, c):
    """``a * b + c`` rounded once to fp32, as an FMA: exact in fp64 for these
    fp32 operands, then one rounding (a double rounding needs an fp64 result
    within 2^-53 of an fp32 midpoint)."""
    a, b, c = (x.double() if isinstance(x, torch.Tensor) else x for x in (a, b, c))
    return (a * b + c).float()


def _xla_lagrange_weights(t):
    return (-t * (t - 1.0) * (t - 2.0) * _SIXTH,
            (t + 1.0) * (t - 1.0) * (t - 2.0) / 2.0,
            -(t + 1.0) * t * (t - 2.0) / 2.0,
            (t + 1.0) * t * (t - 1.0) * _SIXTH)


def _xla_bspline_plan_weights(t):
    """One fusion per weight: every multiply-add contracts."""
    t2 = t * t
    t3 = t2 * t
    return (_fma(-t2, t, _fma(3.0, t2, _fma(-3.0, t, 1.0))) * _SIXTH,
            _fma(3.0, t3, _fma(-6.0, t2, 4.0)) * _SIXTH,
            _fma(-3.0, t3, _fma(3.0, t2, _fma(3.0, t, 1.0))) * _SIXTH,
            t3 * _SIXTH)


def _xla_bspline_query_weights(t):
    """One fusion for all four: 3t, 3t², t³ and 3t³ are shared, 6t² is not."""
    t2 = t * t
    t3 = t2 * t
    return ((((1.0 - 3.0 * t) + 3.0 * t2) - t3) * _SIXTH,
            (_fma(-6.0, t2, 4.0) + 3.0 * t3) * _SIXTH,
            (((3.0 * t + 1.0) + 3.0 * t2) - 3.0 * t3) * _SIXTH,
            t3 * _SIXTH)


class Basis(NamedTuple):
    selector: int                # passed to K4
    support: int                 # taps per axis
    offset: int                  # base index offset from floor(q)
    fp32_plan_weights: Callable  # the formulas as the source reads them
    xla_plan_weights: Callable   # JAX's build_plan under jit (bf16 plans)
    xla_query_weights: Callable  # JAX's interp_field under jit (K4)


BASES = {
    "linear": Basis(0, 2, 0, linear_weights, linear_weights, linear_weights),
    "cubic_bspline": Basis(1, 4, -1, bspline_weights, _xla_bspline_plan_weights,
                           _xla_bspline_query_weights),
    "cubic_lagrange": Basis(2, 4, -1, lagrange_weights, _xla_lagrange_weights,
                            _xla_lagrange_weights),
}


def plan_weights(basis: str, t: torch.Tensor, weight_dtype=None):
    """A plan's basis weights at fractions ``t``: fp32, or rounded to
    ``weight_dtype`` from the arithmetic of JAX's jitted ``build_plan``."""
    if weight_dtype is None:
        return BASES[basis].fp32_plan_weights(t)
    return tuple(w.to(weight_dtype) for w in BASES[basis].xla_plan_weights(t))


def query_weights(basis: str, t: torch.Tensor, weight_dtype=None):
    """K4's basis weights at fractions ``t``, in the arithmetic of JAX's
    jitted ``interp_field``, rounded to ``weight_dtype`` unless None."""
    w = BASES[basis].xla_query_weights(t)
    return w if weight_dtype is None else tuple(x.to(weight_dtype) for x in w)


def _tap_product(wab: torch.Tensor, w3: torch.Tensor, vals: torch.Tensor):
    """``wab * w3 * vals`` with ``wab * w3`` in fp32 (exact for bf16 weights,
    as XLA keeps it); ``wab`` was rounded to the weight dtype."""
    return wab.float() * w3.float() * vals


# ---------------------------------------------------------------------------
# ctypes bindings
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_PLAN_ARGS = (_P, _P, _P, _P, _P, _P)
#: output dims (m1, m2, m3) and the block's tile (t1, t2, t3)
_TILE_ARGS = (_I,) * 6
_K2_ARGS = ((_P, _P, _I, ctypes.c_longlong, ctypes.c_longlong, _I) + _PLAN_ARGS
            + _TILE_ARGS + (_P,))
_K3_ARGS = ((_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _I) + _PLAN_ARGS
            + (_I, ctypes.c_float, ctypes.c_float) + _TILE_ARGS + (_P,))
_SIGNATURES = {
    "apply_plan_f32": _K2_ARGS,
    "apply_plan_bf16": _K2_ARGS,
    "apply_plan_fused_f32": _K3_ARGS,
    "apply_plan_fused_bf16": _K3_ARGS,
    "interp3d_f32": ((_P, _P, _P, _I, _I, _I, _I, ctypes.c_longlong, _I, _I)
                     + _TILE_ARGS + (_P, _P)),
}

# ---------------------------------------------------------------------------
# K2 / K3 / K4 block mapping and source box (``csrc/interp3d.cu``)
# ---------------------------------------------------------------------------

#: The output tile of one 256-thread K2 / K3 / K4 block, (x1, x2, x3), x3
#: fastest: a 3D output takes TILE_3D (one query a thread), or TILE_3D_BOX
#: for K4's cubic bases, which stage their source box (8 queries a thread,
#: x1 rows 2 apart, so that one box serves 2048 queries); an output of any
#: other rank is flattened to (1, 1, M) and takes TILE_FLAT. Linear K4 and K2
#: stage no box: both measured slower with one on the H100 (PERF.md, kernel table).
TILE_3D = (2, 4, 32)
TILE_3D_BOX = (16, 4, 32)
TILE_FLAT = (1, 1, 256)
#: Floats of a block's shared-memory source box (``kBoxFloats``, 48 KB),
#: and the most a box may span along x3 (``kBoxMaxE3``).
BOX_FLOATS = 12288
BOX_MAX_E3 = 64
_GRID_YZ_MAX = 65535
_INT_MAX = 2 ** 31 - 1


def interp3d_tile(basis: str):
    """K4's 3D output tile for ``basis``: the cubic bases stage a box."""
    return TILE_3D_BOX if BASES[basis].support == 4 else TILE_3D


def out_tiling(out_shape, tile3d=TILE_3D):
    """``(dims, tile)``: the output as three dims and the block's tile of it,
    as K2, K3 and K4 map their blocks (``tile3d`` for a 3D output)."""
    out_shape = tuple(int(n) for n in out_shape)
    if len(out_shape) == 3 and all(
            -(-d // t) <= _GRID_YZ_MAX for d, t in zip(out_shape[:2], tile3d[:2])):
        return out_shape, tuple(tile3d)
    return (1, 1, math.prod(out_shape)), TILE_FLAT


def tile_blocks(out_shape, tile3d=TILE_3D) -> int:
    """The number of K2 / K3 / K4 blocks over ``out_shape``."""
    dims, tile = out_tiling(out_shape, tile3d)
    return math.prod(-(-d // t) for d, t in zip(dims, tile))


def _tile_args(out_shape, tile3d=TILE_3D):
    dims, tile = out_tiling(out_shape, tile3d)
    if dims[2] > _INT_MAX:
        raise ValueError(f"output of {dims[2]} points exceeds the kernels' int range")
    return dims + tile


def _counter_arg(box_blocks, device):
    """K4's diagnostic counter: None or a one-element int32 tensor on the
    coefficients' device (its pointer)."""
    if box_blocks is None:
        return None
    if (box_blocks.dtype != torch.int32 or box_blocks.numel() != 1
            or box_blocks.device != device):
        raise ValueError("box_blocks must be a one-element int32 tensor on the "
                         "coefficients' device")
    return box_blocks.data_ptr()

#: weight dtype -> (suffix of the C entry points, suffix of the count key).
_WEIGHT_ROUTES = {torch.float32: ("f32", ""), torch.bfloat16: ("bf16", ":bf16")}


def _weight_route(dtype):
    if dtype not in _WEIGHT_ROUTES:
        raise TypeError(f"the interpolation kernels take float32 or bfloat16 "
                        f"weights, got {dtype}")
    return _WEIGHT_ROUTES[dtype]


def _plain_suffix(dtype) -> str:
    """The count-key suffix of a plain run (which takes any weight dtype)."""
    return _WEIGHT_ROUTES.get(dtype, ("", ""))[1]


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_kernel_coef(coef: torch.Tensor, what: str) -> None:
    """The kernels' own demands on the coefficients (the CUDA and the fake
    route)."""
    if coef.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes float32 coefficients, got {coef.dtype}")
    if not coef.is_contiguous():
        raise ValueError(f"{what} kernel needs contiguous coefficients")


def _check_cuda_coef(coef: torch.Tensor, what: str) -> None:
    if coef.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {coef.device}")
    _check_kernel_coef(coef, what)


def gather_flops(n_out: int, support: int, n_fields: int = 1) -> float:
    """Operations of a tensor-product gather of ``n_fields`` fields at
    ``n_out`` points: a field and point, the S^2 weight pairs and S^3 taps
    of two multiplies and an add (the bound of ``chip_smoke.py``'s
    ``times``)."""
    return float(n_out) * n_fields * (support ** 2 + 3 * support ** 3)


#: K4's operations a query besides the taps: floor, fraction and weights on
#: three axes (the B-spline's ~22 per axis; 3 for linear)
QUERY_WEIGHT_OPS = {"linear": 9, "cubic_bspline": 66, "cubic_lagrange": 60}
#: K3's epilogue operations a point
EPILOGUE_OPS = {"inc_state": 3, "inc_adjoint": 6}


# ---------------------------------------------------------------------------
# K2: plan gather
# ---------------------------------------------------------------------------


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
                acc = acc + _tap_product(wab, w3[c], vals).to(torch.float32)
    return acc


def _plan_args(plan, device):
    """The plan's six pointers and its weight route (C suffix, count suffix)."""
    route = _check_plan_tensors(plan, device)
    return [t.data_ptr() for t in plan.idx] + [t.data_ptr() for t in plan.weights], route


def _check_plan_tensors(plan, device):
    """The kernels' demands on a plan; its weight route."""
    for t in plan.idx:
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != device:
            raise ValueError("plan indices must be contiguous int32 on the "
                             "coefficients' device")
    route = _weight_route(plan.weights[0].dtype)
    for t in plan.weights:
        if (t.dtype != plan.weights[0].dtype or not t.is_contiguous()
                or t.device != device):
            raise ValueError("plan weights must be contiguous, of one dtype, on "
                             "the coefficients' device")
    if plan.support not in (2, 4):
        raise ValueError(f"plan support {plan.support} not in (2, 4)")
    return route


def apply_plan(coef: torch.Tensor, plan) -> torch.Tensor:
    """K2: evaluate ``coef`` ``(..., N1, N2, N3)`` through ``plan``; returns
    ``coef.shape[:-3] + plan.out_shape`` in float32."""
    _check_plan(coef, plan)
    lead = tuple(coef.shape[:-3])
    out_shape = tuple(plan.out_shape)
    if counts.is_fake(coef):
        _check_kernel_coef(coef, "apply_plan")
        _, key_suffix = _check_plan_tensors(plan, coef.device)
        out = torch.empty(lead + out_shape, dtype=torch.float32, device=coef.device)
        counts.fake_launch("apply_plan" + key_suffix,
                           gather_flops(math.prod(out_shape), plan.support, math.prod(lead)),
                           counts.nbytes(coef, out, *plan.idx, *plan.weights))
        return out
    if coef.device.type == "cpu":
        counts.bump("plain:apply_plan" + _plain_suffix(plan.weights[0].dtype))
        return apply_plan_plain(coef, plan)
    _check_cuda_coef(coef, "apply_plan")
    ptrs, (c_suffix, key_suffix) = _plan_args(plan, coef.device)
    out = torch.empty(lead + out_shape, dtype=torch.float32, device=coef.device)
    lib = _build.library("interp3d", _SIGNATURES)
    with torch.cuda.device(coef.device):
        rc = getattr(lib, "apply_plan_" + c_suffix)(
            coef.data_ptr(), out.data_ptr(), math.prod(lead), math.prod(plan.field_shape),
            math.prod(out_shape), plan.support, *ptrs, *_tile_args(out_shape),
            _stream(coef))
    _build.check(rc, "apply_plan")
    counts.bump("apply_plan" + key_suffix)
    return out


# ---------------------------------------------------------------------------
# K3: plan gather + matvec epilogue
# ---------------------------------------------------------------------------


def apply_plan_fused_plain(coefs: torch.Tensor, plan, extra: torch.Tensor,
                           epilogue: str, dt: float) -> torch.Tensor:
    """Plain version of K3: gather the two stacked fields, then the epilogue."""
    acc = apply_plan_plain(coefs, plan)
    return EPILOGUES[epilogue][1](acc[0], acc[1], extra, dt)


def _check_extra(extra: torch.Tensor, coefs: torch.Tensor) -> None:
    if (extra.dtype != torch.float32 or not extra.is_contiguous()
            or extra.device != coefs.device):
        raise ValueError("extra field must be contiguous float32 on the "
                         "coefficients' device")


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
    if counts.is_fake(coefs):
        _check_kernel_coef(coefs, "apply_plan_fused")
        _check_extra(extra, coefs)
        _, key_suffix = _check_plan_tensors(plan, coefs.device)
        out = torch.empty(out_shape, dtype=torch.float32, device=coefs.device)
        m = math.prod(out_shape)
        counts.fake_launch("apply_plan_fused:" + epilogue + key_suffix,
                           gather_flops(m, plan.support, 2) + m * EPILOGUE_OPS[epilogue],
                           counts.nbytes(coefs, extra, out, *plan.idx, *plan.weights))
        return out
    if coefs.device.type == "cpu":
        counts.bump("plain:apply_plan_fused:" + epilogue
                    + _plain_suffix(plan.weights[0].dtype))
        return apply_plan_fused_plain(coefs, plan, extra, epilogue, dt)
    _check_cuda_coef(coefs, "apply_plan_fused")
    _check_extra(extra, coefs)
    ptrs, (c_suffix, key_suffix) = _plan_args(plan, coefs.device)
    out = torch.empty(out_shape, dtype=torch.float32, device=coefs.device)
    lib = _build.library("interp3d", _SIGNATURES)
    with torch.cuda.device(coefs.device):
        rc = getattr(lib, "apply_plan_fused_" + c_suffix)(
            coefs.data_ptr(), extra.data_ptr(), out.data_ptr(),
            math.prod(plan.field_shape), math.prod(out_shape), plan.support, *ptrs,
            EPILOGUES[epilogue][0], float(0.5 * dt), float(dt), *_tile_args(out_shape),
            _stream(coefs))
    _build.check(rc, "apply_plan_fused")
    counts.bump("apply_plan_fused:" + epilogue + key_suffix)
    return out


# ---------------------------------------------------------------------------
# K4: plan-free interpolation at query points
# ---------------------------------------------------------------------------


def _check_interp_args(coef: torch.Tensor, q: torch.Tensor, basis: str) -> None:
    if basis not in BASES:
        raise ValueError(f"unknown basis {basis!r}; expected one of {sorted(BASES)}")
    if coef.dim() < 3:
        raise ValueError(f"expected coefficients (..., N1, N2, N3), got "
                         f"{tuple(coef.shape)}")
    if q.dim() < 2 or q.shape[0] != 3:
        raise ValueError(f"expected query points (3, ...), got {tuple(q.shape)}")


def interp3d_plain(coef: torch.Tensor, q: torch.Tensor, basis: str = "cubic_bspline",
                   weight_dtype=None) -> torch.Tensor:
    """Plain version of K4: interpolate ``coef`` ``(..., N1, N2, N3)`` at the
    index-unit query points ``q`` ``(3, *out_shape)`` with periodic wrap;
    the arithmetic and tap order of ``repro.core.interp._interp_separable``.
    Returns ``coef.shape[:-3] + out_shape`` in float32."""
    _check_interp_args(coef, q, basis)
    support, base_off = BASES[basis].support, BASES[basis].offset
    n1, n2, n3 = (int(n) for n in coef.shape[-3:])
    lead = tuple(coef.shape[:-3])
    out_shape = tuple(q.shape[1:])
    qf = torch.floor(q)
    t = q - qf
    base = qf.to(torch.int32) + base_off
    w1, w2, w3 = (query_weights(basis, t[a], weight_dtype) for a in range(3))
    f_flat = coef.reshape(lead + (-1,))
    acc = torch.zeros(lead + out_shape, dtype=torch.float32, device=coef.device)
    for a in range(support):
        i1 = torch.remainder(base[0] + a, n1) * (n2 * n3)
        for b in range(support):
            i12 = i1 + torch.remainder(base[1] + b, n2) * n3
            wab = w1[a] * w2[b]
            for c in range(support):
                idx = (i12 + torch.remainder(base[2] + c, n3)).reshape(-1).long()
                vals = f_flat.index_select(-1, idx).reshape(lead + out_shape)
                acc = acc + _tap_product(wab, w3[c], vals).to(torch.float32)
    return acc


def _check_kernel_interp(coef: torch.Tensor, q: torch.Tensor, weight_dtype) -> str:
    """K4's demands on its inputs; the count key's weight suffix."""
    _check_kernel_coef(coef, "interp3d")
    _, key_suffix = _weight_route(torch.float32 if weight_dtype is None
                                  else weight_dtype)
    if q.dtype != torch.float32 or not q.is_contiguous() or q.device != coef.device:
        raise ValueError("query points must be contiguous float32 on the "
                         "coefficients' device")
    return key_suffix


def interp3d(coef: torch.Tensor, q: torch.Tensor, basis: str = "cubic_bspline",
             weight_dtype=None, *, box_blocks: torch.Tensor | None = None) -> torch.Tensor:
    """K4: interpolate ``coef`` ``(..., N1, N2, N3)`` (all leading fields
    share ``q``) at the index-unit query points ``q`` ``(3, *out_shape)``.

    For ``cubic_bspline`` the caller passes prefiltered coefficients.
    ``weight_dtype`` None (fp32) or ``torch.bfloat16`` rounds the basis
    weights only. The wrap is global, so any ``q`` is exact; the Pallas
    kernel's ``displacement_bound`` (its halo-tile contract) has no
    counterpart here. Returns ``coef.shape[:-3] + out_shape`` in float32.

    The cubic bases stage each block's source box in shared memory where it
    fits (``interp3d_tile``); ``box_blocks``, a one-element int32 tensor on
    the card, counts the blocks that did (a diagnostic).
    """
    _check_interp_args(coef, q, basis)
    name = "interp3d:" + basis
    lead = tuple(coef.shape[:-3])
    out_shape = tuple(q.shape[1:])
    if counts.is_fake(coef):
        key_suffix = _check_kernel_interp(coef, q, weight_dtype)
        out = torch.empty(lead + out_shape, dtype=torch.float32, device=coef.device)
        m = math.prod(out_shape)
        counts.fake_launch(name + key_suffix,
                           m * QUERY_WEIGHT_OPS[basis]
                           + gather_flops(m, BASES[basis].support, math.prod(lead)),
                           counts.nbytes(coef, q, out))
        return out
    if coef.device.type == "cpu":
        counts.bump("plain:" + name + _plain_suffix(weight_dtype))
        return interp3d_plain(coef, q, basis, weight_dtype)
    _check_cuda_coef(coef, "interp3d")
    key_suffix = _check_kernel_interp(coef, q, weight_dtype)
    n1, n2, n3 = (int(n) for n in coef.shape[-3:])
    out = torch.empty(lead + out_shape, dtype=torch.float32, device=coef.device)
    counter = _counter_arg(box_blocks, coef.device)
    lib = _build.library("interp3d", _SIGNATURES)
    with torch.cuda.device(coef.device):
        rc = lib.interp3d_f32(coef.data_ptr(), q.data_ptr(), out.data_ptr(),
                              math.prod(lead), n1, n2, n3, math.prod(out_shape),
                              BASES[basis].selector, int(weight_dtype is not None),
                              *_tile_args(out_shape, interp3d_tile(basis)), counter,
                              _stream(coef))
    _build.check(rc, "interp3d")
    counts.bump(name + key_suffix)
    return out

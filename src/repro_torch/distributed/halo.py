"""Slab-halo primitives of the slab-parallel solve (port of
``repro.distributed.halo``).

One registration is spread over the ranks of a ``torch.distributed`` group
by cutting the x1 axis into slabs (the multi-node CLAIRE layout of Brunn et
al. 2020). Each rank holds a slab ``(..., N1/P, N2, N3)`` and runs the same
host loop; every operator of the optimality system falls into one of four
communication classes:

  * FD8 stencils        -> fixed-width (4) halo exchange, then the valid-mode
                           x1 stencil (kernel K5) and the periodic stencil on
                           the local x2/x3 axes (K1),
  * SL interpolation    -> CFL-bounded halo exchange (displacement + taps,
                           plus the 7-row B-spline prefilter radius), then
                           plans in the extended slab's frame (K1, K2, K3),
  * spectral operators  -> all-gather + local FFT + slice,
  * inner products      -> local partial sums + one scalar all-reduce.

The JAX ``ShardInfo.axis`` (a mesh axis name) becomes ``group``, the slab
position comes from ``rank`` instead of ``lax.axis_index``, and the JAX
``backend`` is dropped: the kernels dispatch on the tensors' device (plain
versions on the CPU, CUDA kernels on the card).

CFL contract: per-step footpoint displacement along x1 must satisfy
``|foot_1 - x_1| <= halo - 2`` (the cubic stencil reaches floor(q)-1 ..
floor(q)+2); footpoints past it are clamped to the exchanged slab.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.distributed as dist

from ..core import grid as _grid
from ..core import interp as _interp
from ..kernels import fd8 as _fd8
from ..kernels import pencil as _pencil
from . import compression as _comp

FD8_COEFFS = _fd8.FD8_COEFFS
FD8_HALO = len(FD8_COEFFS)  # stencil radius 4


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """The slab decomposition, carried by ``TransportConfig.shard``.

    nshards  : number of slabs (ranks of ``group``)
    rank     : this rank's slab, in ``group``
    halo     : interpolation halo width in voxels (CFL bound + stencil
               margin); the FD8 halo (4) and the prefilter radius (7) are
               added internally
    compress : "none" or "int8": halo payloads travel as absmax int8; the
               owned slab interior stays exact
    group    : the ``torch.distributed`` process group (None: the default)
    """

    nshards: int
    rank: int
    halo: int = 6
    compress: str = "none"
    group: object = None

    @classmethod
    def of_group(cls, group=None, halo: int = 6, compress: str = "none") -> "ShardInfo":
        if compress not in ("none", "int8"):
            raise ValueError(f"halo compression is 'none' or 'int8', got {compress!r}")
        return cls(nshards=dist.get_world_size(group), rank=dist.get_rank(group),
                   halo=halo, compress=compress, group=group)

    def global_shape(self, local_shape) -> Tuple[int, int, int]:
        n1, n2, n3 = (int(n) for n in tuple(local_shape)[-3:])
        return (n1 * self.nshards, n2, n3)


def _x1(f: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Rows [start:stop) of the x1 axis (axis -3) of ``f``."""
    return f.narrow(-3, start, stop - start)


def _all_gather(x: torch.Tensor, shard: ShardInfo):
    """Every rank's ``x``, in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(shard.nshards)]
    dist.all_gather(parts, x, group=shard.group)
    return parts


def _send_recv(send_t: torch.Tensor, send_b: torch.Tensor, shard: ShardInfo):
    """One ring hop: ``send_t`` goes to the right neighbour while the left
    neighbour's arrives, ``send_b`` to the left while the right one's
    arrives. With int8 compression each payload travels quantised with its
    scale beside it."""
    left = (shard.rank - 1) % shard.nshards
    right = (shard.rank + 1) % shard.nshards
    msgs = []   # (tensor to send, peer, receive buffer, peer, tag)
    for payload, to, frm in ((send_t, right, left), (send_b, left, right)):
        payload = payload.contiguous()
        if shard.compress == "int8":
            q, s = _comp.quantize_int8(payload)
            s = s.reshape(1)
            msgs.append((q, to, torch.empty_like(q), frm, 0))
            msgs.append((s, to, torch.empty_like(s), frm, 1))
        else:
            msgs.append((payload, to, torch.empty_like(payload), frm, 0))
    ops = []
    for x, to, buf, frm, tag in msgs:
        ops.append(dist.P2POp(dist.isend, x, group=shard.group, group_peer=to, tag=tag))
        ops.append(dist.P2POp(dist.irecv, buf, group=shard.group, group_peer=frm, tag=tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    bufs = [m[2] for m in msgs]
    if shard.compress == "int8":
        return (_comp.dequantize_int8(bufs[0], bufs[1][0]),
                _comp.dequantize_int8(bufs[2], bufs[3][0]))
    return bufs[0], bufs[1]


def exchange(f: torch.Tensor, halo: int, shard: ShardInfo) -> torch.Tensor:
    """Extend the local slab by ``halo`` rows of the periodic global field on
    each side of the x1 axis: output x1 length = local + 2*halo.

    Nearby halos travel over a ring of ``ceil(halo / n_local)`` hops of
    point-to-point sends to the neighbours; when the ring would reach most
    of the group anyway (``2*hops + 1 >= P``) the exchange is one all-gather
    and a periodic window, which is also what small grids and one-rank
    groups take.
    """
    if halo <= 0:
        return f
    n_loc = f.shape[-3]
    n = shard.nshards
    hops = -(-halo // n_loc)  # ceil
    if 2 * hops + 1 >= n:
        n_glob = n_loc * n
        start = shard.rank * n_loc
        idx = torch.remainder(torch.arange(start - halo, start + n_loc + halo,
                                           device=f.device), n_glob)
        if shard.compress == "int8":
            # int8 all-gather; the own (interior) rows are re-spliced exactly,
            # so quantisation only touches the remote halo rows.
            q, s = _comp.quantize_int8(f)
            qs = _all_gather(q, shard)
            ss = _all_gather(s.reshape(1), shard)
            full = torch.cat([_comp.dequantize_int8(qi, si[0]).to(f.dtype)
                              for qi, si in zip(qs, ss)], dim=-3)
            ext = full.index_select(f.dim() - 3, idx)
            return torch.cat([_x1(ext, 0, halo), f,
                              _x1(ext, halo + n_loc, n_loc + 2 * halo)], dim=-3)
        full = torch.cat(_all_gather(f, shard), dim=-3)
        return full.index_select(f.dim() - 3, idx)
    # Intermediate hops forward whole slabs to keep the chain intact; the
    # final hop's source slab only contributes its ``rem`` rows nearest the
    # boundary, so each direction moves exactly ``halo`` rows on that hop.
    rem = halo - (hops - 1) * n_loc
    top_parts, bot_parts = [], []
    cur_t, cur_b = f, f
    for h in range(hops):
        send_t, send_b = cur_t, cur_b
        if h == hops - 1:
            send_t = _x1(cur_t, n_loc - rem, n_loc)
            send_b = _x1(cur_b, 0, rem)
        cur_t, cur_b = _send_recv(send_t, send_b, shard)  # from left / right
        top_parts.insert(0, cur_t)
        bot_parts.append(cur_b)
    return torch.cat(top_parts + [f] + bot_parts, dim=-3)


def gather_full(f: torch.Tensor, shard: ShardInfo) -> torch.Tensor:
    """All-gather the x1 axis: the full global field, on every rank."""
    return torch.cat(_all_gather(f, shard), dim=-3)


def slice_local(full: torch.Tensor, n_loc: int, shard: ShardInfo) -> torch.Tensor:
    """This rank's slab of a gathered global field (contiguous)."""
    return _x1(full, origin(n_loc, shard), origin(n_loc, shard) + n_loc).contiguous()


def origin(n_loc: int, shard: ShardInfo) -> int:
    """Global x1 index of the first local row."""
    return shard.rank * n_loc


# ---------------------------------------------------------------------------
# FD8 with halo exchange (leading batch axes allowed, so a stored trajectory
# is differentiated in one stacked pass).
# ---------------------------------------------------------------------------


def _fd8_valid_x1(f_ext: torch.Tensor, h: float) -> torch.Tensor:
    """d/dx1 on the interior rows of a halo-extended slab (kernel K5)."""
    return _pencil.stencil_valid(f_ext, 0, FD8_COEFFS, scale=1.0 / h)


def _fd8_local(f: torch.Tensor, axis: int, h: float) -> torch.Tensor:
    """Periodic FD8 along local axis 1 or 2 (kernel K1)."""
    return _pencil.stencil_axis(f, axis, FD8_COEFFS, symmetric=False, scale=1.0 / h)


def fd8_grad(f: torch.Tensor, shard: ShardInfo) -> torch.Tensor:
    """FD8 gradient of scalar field(s) ``(..., N1/P, N2, N3)``; the component
    axis is inserted before the three spatial axes: ``(..., 3, N1/P, N2, N3)``."""
    f = f.contiguous()
    h = _grid.spacing(shard.global_shape(f.shape))
    d0 = _fd8_valid_x1(exchange(f, FD8_HALO, shard), h[0])
    return torch.stack([d0, _fd8_local(f, 1, h[1]), _fd8_local(f, 2, h[2])], dim=-4)


def fd8_div(w: torch.Tensor, shard: ShardInfo) -> torch.Tensor:
    """FD8 divergence of a vector field (3, N1/P, N2, N3) -> (N1/P, N2, N3)."""
    h = _grid.spacing(shard.global_shape(w.shape))
    w = w.contiguous()
    return (_fd8_valid_x1(exchange(w[0], FD8_HALO, shard), h[0])
            + _fd8_local(w[1], 1, h[1]) + _fd8_local(w[2], 2, h[2]))


def spectral_grad(f: torch.Tensor, shard: ShardInfo) -> torch.Tensor:
    """FFT gradient via all-gather + local FFT + slice."""
    from ..core import derivatives as _deriv

    return slice_local(_deriv.spectral_grad(gather_full(f, shard)), f.shape[-3], shard)


def spectral_div(w: torch.Tensor, shard: ShardInfo) -> torch.Tensor:
    from ..core import derivatives as _deriv

    return slice_local(_deriv.spectral_div(gather_full(w, shard)), w.shape[-3], shard)


# ---------------------------------------------------------------------------
# Halo-local semi-Lagrangian interpolation: CFL-bounded halo exchange and the
# build-once/apply-many plans of ``core.interp``, built in the extended
# slab's frame (x1 clamped, x2/x3 periodic).
# ---------------------------------------------------------------------------


def _prefilter_pad(method: str) -> int:
    return _interp.PREFILTER_RADIUS if method == "cubic_bspline" else 0


def build_plan(foot: torch.Tensor, method: str, weight_dtype, shard: ShardInfo
               ) -> _interp.InterpPlan:
    """Interpolation plan for *global-coordinate* footpoints of a local slab.

    ``foot`` is (3, N1/P, N2, N3) in global index units. The x1 coordinate is
    rebased to the halo-extended local frame, so applying the plan needs only
    the extended coefficient slab of :func:`sl_coefficients`.
    """
    n_loc = foot.shape[-3]
    x0 = float(origin(n_loc, shard) - shard.halo)
    q = torch.stack([foot[0] - x0, foot[1], foot[2]])
    ext_shape = (n_loc + 2 * shard.halo,) + tuple(foot.shape[-2:])
    return _interp.build_plan(q, method=method, weight_dtype=weight_dtype,
                              shape=ext_shape, wrap=(False, True, True))


def sl_coefficients(f: torch.Tensor, method: str, shard: ShardInfo) -> torch.Tensor:
    """Halo-extended interpolation coefficients of local field(s) ``f``.

    One exchange of width ``halo + prefilter radius`` and the local FIR
    prefilter (K1, periodic on the extended slab); the pad rows, the only
    ones the prefilter's wrap reaches, are trimmed, so the returned slab
    covers exactly the plan's extended frame ``N1/P + 2*halo`` and its
    coefficients are exact.
    """
    pad = _prefilter_pad(method)
    coef = _interp.prefilter_for(exchange(f.contiguous(), shard.halo + pad, shard), method)
    if pad:
        coef = _x1(coef, pad, coef.shape[-3] - pad)
    return coef.contiguous()


def apply_plan(plan: _interp.InterpPlan, f: torch.Tensor, method: str,
               shard: ShardInfo) -> torch.Tensor:
    """One sharded SL step through a prebuilt halo plan (exchange + gather)."""
    return _interp.apply_plan(plan, sl_coefficients(f, method, shard))


def interp(f: torch.Tensor, foot: torch.Tensor, method: str, weight_dtype,
           shard: ShardInfo) -> torch.Tensor:
    """Sharded interpolation through a throwaway halo plan."""
    return apply_plan(build_plan(foot, method, weight_dtype, shard), f, method, shard)


def index_coords_local(shape_loc, shard: ShardInfo, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """Global index-unit coordinates of the local slab, (3, N1/P, N2, N3)."""
    x = _grid.index_coords(tuple(shape_loc), dtype=dtype, device=device)
    x0 = float(origin(int(shape_loc[0]), shard))
    return torch.cat([x[0:1] + x0, x[1:]])


def trace_characteristic(v: torch.Tensor, dt: float, method: str, sign: float,
                         weight_dtype, shard: ShardInfo) -> torch.Tensor:
    """RK2 backward characteristic trace on a slab (cf. ``core.semilag``):
    the midpoint velocity is a halo-local interpolation, and the returned
    footpoints are *global* index coordinates of local grid points."""
    lshape = tuple(v.shape[-3:])
    h = torch.tensor(_grid.spacing(shard.global_shape(lshape)), dtype=v.dtype,
                     device=v.device).reshape(3, 1, 1, 1)
    x = index_coords_local(lshape, shard, dtype=v.dtype, device=v.device)
    q_mid = x - sign * (0.5 * dt) * v / h
    coef = sl_coefficients(v, method, shard)
    plan = build_plan(q_mid, method, weight_dtype, shard)
    v_mid = _interp.apply_plan(plan, coef)
    return x - sign * dt * v_mid / h


# ---------------------------------------------------------------------------
# Spectral operators (regularizer, preconditioner): all-gather.
# ---------------------------------------------------------------------------


def spectral_op(op, v: torch.Tensor, shard: ShardInfo) -> torch.Tensor:
    """Apply a global spectral field->field operator: gather, apply, slice."""
    return slice_local(op(gather_full(v, shard)), v.shape[-3], shard)

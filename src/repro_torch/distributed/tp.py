"""Tensor- and sequence-parallel compute over a mesh's ``model`` axis.

The counterpart of what GSPMD does in JAX under the four activation rules
of ``repro_torch.distributed.sharding`` (``residual_constraint``,
``qkv_constraint``, ``ssm_inner_constraint``, ``expert_constraint``): the
ranks of one ``model`` group split a forward's work, each computing on the
blocks of the weights that ``param_specs`` gives it.

Gradient convention. On the ranks of one model group an activation is
  * *split*: each rank holds its own block (its rows of the sequence, its
    heads, its vocab columns, its experts); its gradient on a rank is that
    block's gradient;
  * *whole*: every rank holds the same tensor; its gradient on a rank is a
    share, and the ranks' shares add up to the gradient;
  * *partial*: each rank holds a summand (a row-parallel product) of a
    tensor that is their sum; its gradient on every rank is the sum's.
Under this convention every op a whole tensor meets needs no collective in
backward: a column-parallel product of a whole input, a replicated region
(the router, the SSM's B and C, cross-attention's K/V, the encoder's
output) or a slice. So one rule holds for every leaf used whole, whatever
the residual layout: its gradient ends backward as a share on each rank and
is all-reduced once (a gathered leaf's shares are reduce-scattered by the
gather's own backward), and a whole scalar loss seeds backward with
``1/m``. Megatron's convention (whole tensors carry the whole gradient)
puts the same collectives elsewhere: its copy-in (identity forward,
all-reduce backward) is the identity here, and its all-reduce-out
(identity backward) is :func:`reduce`, whose backward all-reduces the
shares; the seq gather and the reduce-scatter keep their conjugates.

The ops, each an autograd ``Function`` over the group (``m`` ranks):
  :func:`gather`          split -> whole: all-gather / reduce-scatter
  :func:`split`           whole -> split: the rank's block / zero-padded block
  :func:`reduce`          partial -> whole: all-reduce / all-reduce
  :func:`reduce_scatter`  partial -> split: all-reduce, the rank's block /
                          all-gather
gloo has no reduce-scatter: both backends take an all-reduce and the
rank's block. Every mesh has a model group: on one rank (no mesh, an
abstract mesh or a ``model`` axis of size 1: :data:`ONE`) every op and
collective returns its input, every span is the whole, and the model's one
code path is the one-device computation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..launch.mesh import SHAPE_AXES, Mesh
from . import sharding as shd


class Ctx(NamedTuple):
    """The model group a forward runs on: its process group (None on one
    rank), its size ``m``, this rank's index ``r`` in it, and the mesh,
    whose activation rules (``sharding.*_constraint``) pick each op's
    layout."""

    group: object
    size: int
    rank: int
    mesh: object


class Layout(NamedTuple):
    """The rows of a sequence of ``full`` positions: this rank's ``n`` rows
    from ``lo``, and whether the residual stream is held split into them
    (``sharding.residual_constraint``: the sequence splits over the group);
    else all of them, the residual whole on every rank."""

    ctx: Ctx
    full: int
    lo: int
    n: int
    split: bool


#: one rank: the group of no mesh (an abstract (1, 1) mesh)
ONE = Ctx(None, 1, 0, Mesh((1, 1), SHAPE_AXES))


def context(mesh) -> Ctx:
    """``mesh``'s model group; :data:`ONE`'s (on ``mesh``) when the mesh is
    abstract or its ``model`` axis has size 1."""
    m = mesh.shape.get("model", 1) if "model" in mesh.axis_names else 1
    if mesh.abstract or m == 1:
        return ONE._replace(mesh=mesh)
    return Ctx(mesh.group("model"), m, mesh.coordinate("model"), mesh)


def span(ctx: Ctx, n: int) -> Tuple[int, int]:
    """This rank's block ``[lo, hi)`` of ``n`` items split over the group,
    or ``(0, n)`` when ``n`` does not split (fewer than ``m``, or a rest)."""
    if n % ctx.size or n < ctx.size:
        return 0, n
    b = n // ctx.size
    return ctx.rank * b, (ctx.rank + 1) * b


def layout(ctx: Ctx, full: int) -> Layout:
    """The residual stream's layout over a sequence of ``full`` positions."""
    split = shd.residual_constraint(ctx.mesh)((1, full, 1))[1] is not None
    lo, hi = span(ctx, full) if split else (0, full)
    return Layout(ctx, full, lo, hi - lo, split)


# ---------------------------------------------------------------------------
# Collectives (no autograd)
# ---------------------------------------------------------------------------


def all_gather(x: torch.Tensor, dim: int, ctx: Ctx) -> torch.Tensor:
    if ctx.size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ctx.size)]
    dist.all_gather(parts, x, group=ctx.group)
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, ctx: Ctx, op=dist.ReduceOp.SUM) -> torch.Tensor:
    if ctx.size == 1:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=ctx.group)
    return x


def block(x: torch.Tensor, dim: int, ctx: Ctx) -> torch.Tensor:
    n = x.shape[dim] // ctx.size
    return x.narrow(dim, ctx.rank * n, n).contiguous()


def pad_block(g: torch.Tensor, dim: int, ctx: Ctx) -> torch.Tensor:
    shape = list(g.shape)
    shape[dim] *= ctx.size
    out = g.new_zeros(shape)
    out.narrow(dim, ctx.rank * g.shape[dim], g.shape[dim]).copy_(g)
    return out


# ---------------------------------------------------------------------------
# The autograd ops
# ---------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, ctx):
        fctx.dim, fctx.ctx = dim, ctx
        return all_gather(x, dim, ctx)

    @staticmethod
    def backward(fctx, g):
        return block(all_reduce(g, fctx.ctx), fctx.dim, fctx.ctx), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, ctx):
        fctx.dim, fctx.ctx = dim, ctx
        return block(x, dim, ctx)

    @staticmethod
    def backward(fctx, g):
        return pad_block(g, fctx.dim, fctx.ctx), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return all_reduce(x, ctx)

    @staticmethod
    def backward(fctx, g):
        return all_reduce(g, fctx.ctx), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, ctx):
        fctx.dim, fctx.ctx = dim, ctx
        return block(all_reduce(x, ctx), dim, ctx)

    @staticmethod
    def backward(fctx, g):
        return all_gather(g, fctx.dim, fctx.ctx), None, None


def gather(x: torch.Tensor, dim: int, ctx: Ctx) -> torch.Tensor:
    """Split -> whole along ``dim``: all-gather; backward reduce-scatter."""
    if ctx.size == 1:
        return x
    return _Gather.apply(x, dim % x.dim(), ctx)


def split(x: torch.Tensor, dim: int, ctx: Ctx) -> torch.Tensor:
    """Whole -> split along ``dim``: this rank's block; backward the block's
    gradient zero-padded to the whole."""
    if ctx.size == 1:
        return x
    return _Split.apply(x, dim % x.dim(), ctx)


def reduce(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """Partial -> whole: all-reduce (sum); backward all-reduce."""
    if ctx.size == 1:
        return x
    return _Reduce.apply(x, ctx)


def reduce_scatter(x: torch.Tensor, dim: int, ctx: Ctx) -> torch.Tensor:
    """Partial -> split along ``dim``: all-reduce and this rank's block;
    backward all-gather."""
    if ctx.size == 1:
        return x
    return _ReduceScatter.apply(x, dim % x.dim(), ctx)


# ---------------------------------------------------------------------------
# Weights: the stored block where it is what the compute needs, else gathered
# ---------------------------------------------------------------------------


def _sharded_dim(w: torch.Tensor, full: Sequence[int], ctx: Ctx) -> Optional[int]:
    """The dim a stored leaf is split on (None when it is whole)."""
    if tuple(w.shape) == tuple(full):
        return None
    diff = [d for d in range(len(full)) if w.shape[d] != full[d]]
    if len(diff) != 1 or w.shape[diff[0]] * ctx.size != full[diff[0]]:
        raise ValueError(f"a leaf of shape {tuple(w.shape)} is no block of {tuple(full)} "
                         f"over {ctx.size} ranks")
    return diff[0]


def take(w: torch.Tensor, full: Sequence[int], ctx: Ctx, dim: int = -1,
         lo: int = 0, hi: Optional[int] = None) -> torch.Tensor:
    """``whole_weight.narrow(dim, lo, hi - lo)`` of a leaf stored as this
    rank's block of a ``full``-shaped weight (or whole): the stored block
    itself when it is exactly that slice, else the slice of the gathered
    weight (:func:`gather`). Default: the whole weight."""
    full = tuple(full)
    dim %= len(full)
    hi = full[dim] if hi is None else hi
    sd = _sharded_dim(w, full, ctx)
    if sd is not None:
        b = full[sd] // ctx.size
        if sd == dim and (lo, hi) == (ctx.rank * b, (ctx.rank + 1) * b):
            return w
        w = gather(w, sd, ctx)
    return w if (lo, hi) == (0, full[dim]) else w.narrow(dim, lo, hi - lo)


def whole(w: torch.Tensor, full: Sequence[int], ctx: Ctx) -> torch.Tensor:
    """The whole weight of a stored leaf (:func:`take` of all of it)."""
    return take(w, full, ctx)


# ---------------------------------------------------------------------------
# Moving between the residual layout and the compute's
# ---------------------------------------------------------------------------


def to_whole(x: torch.Tensor, lay: Layout) -> torch.Tensor:
    """The residual stream -> the whole sequence."""
    return gather(x, 1, lay.ctx) if lay.split else x


def from_partial(y: torch.Tensor, lay: Layout) -> torch.Tensor:
    """A row-parallel product over the whole sequence -> the residual."""
    return reduce_scatter(y, 1, lay.ctx) if lay.split else reduce(y, lay.ctx)


def from_whole(y: torch.Tensor, lay: Layout) -> torch.Tensor:
    """A whole result over the whole sequence -> the residual."""
    return split(y, 1, lay.ctx) if lay.split else y

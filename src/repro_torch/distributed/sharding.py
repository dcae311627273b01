"""Divisibility-aware sharding rules (port of ``repro.distributed.sharding``).

Parameters (memory-driven, Megatron-style TP pairing):
  * embedding / unembedding tables (V, D)     -> vocab over ``model``
  * MoE expert tensors (rep, E, D, F)         -> expert over ``model``
  * column weights  gate/up/wq/wk/wv/in_proj  -> last dim over ``model``
  * row weights     down/wo/out_proj          -> first non-stack dim over ``model``
  * 0/1-D leaves (norms, biases, A_log, ...)  -> replicated
Every rule checks divisibility against the mesh axis size and falls back to
replication, so the rules are total.

Optimizer state (ZeRO-1): parameter spec + the largest remaining unsharded
dim additionally sharded over the data-parallel axes.

Batches: dim 0 over (pod, data), sequence over ``model``; logits (B, S, V)
-> (dp, None, "model"). Caches: KV (B, S, KV, hd) -> batch over dp when
divisible, S over ``model``; SSM states -> batch over dp, heads/width over
``model``.

A spec (:class:`PartitionSpec`) has JAX's entries: per dim None, an axis
name, or a tuple of names, major to minor. The rules read any mesh with
``axis_names`` and a ``shape`` dict (``repro_torch.launch.mesh.Mesh``).
Trees are the port's nested dicts (and lists) of tensors in the JAX layout;
a leaf's path is its keys joined by ``/``, as ``_path_str`` gives them in
JAX. :func:`shard` and :func:`gather` move a full tensor to a rank's block
of a spec and back over the mesh's groups.

Activations (JAX's four constraint hooks, each here a function from an
activation's shape to the spec it asks for): the residual stream between
layer bodies (:func:`residual_constraint`: batch over the data axes, the
sequence over ``model`` where it divides); q, k and v
(:func:`qkv_constraint`: head-parallel when the KV heads split over
``model``, else q's sequence over ``model`` with K/V whole); the SSM's
projection (:func:`ssm_inner_constraint`: its width over ``model``, the
sequence local); the dispatched MoE tensors (:func:`expert_constraint`:
experts over ``model``). ``repro_torch.distributed.tp`` computes on those
layouts: each rank of a model group computes on its blocks.
"""

from __future__ import annotations

import math
import os
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..launch.mesh import axis_size, dp_axis_names

#: parameter-name classes
_COLUMN = ("gate", "up", "wq", "wk", "wv", "in_proj")
_ROW = ("down", "wo", "out_proj")


class PartitionSpec(tuple):
    """One entry per leading dim of a tensor (missing trailing entries are
    None): None (replicated), an axis name, or a tuple of axis names (the
    dim split over their product, major to minor)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec


def _map_with_path(fn: Callable[[str, Any], Any], tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of dicts and lists, keeping its
    structure."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn("/".join(path), tree)


def _shard_dim(shape, dim: int, size: int) -> bool:
    return shape[dim] % size == 0 and shape[dim] >= size


def param_spec(path: str, shape: Tuple[int, ...], mesh) -> P:
    """The spec of one parameter leaf (see the module docstring)."""
    msize = axis_size(mesh, "model")
    if msize == 1 or len(shape) <= 1:
        return P()
    spec = [None] * len(shape)

    leaf = path.rsplit("/", 1)[-1]
    parent = path.rsplit("/", 2)[-2] if path.count("/") >= 1 else ""

    # embeddings: (V, D)
    if leaf == "table":
        if _shard_dim(shape, 0, msize):
            spec[0] = "model"
        return P(*spec)

    # MoE experts: raw arrays named gate/up/down with an expert dim
    # (rep, E, D, F) / (E, D, F), identified by ndim >= 3 and the name
    if leaf in ("gate", "up", "down") and len(shape) >= 3 and parent == "mlp":
        e_dim = len(shape) - 3
        if _shard_dim(shape, e_dim, msize):
            spec[e_dim] = "model"
            return P(*spec)

    kind = path.rsplit("/", 2)[-2] if leaf == "w" else leaf

    if kind in _COLUMN:
        if _shard_dim(shape, len(shape) - 1, msize):
            spec[-1] = "model"
            return P(*spec)
    if kind in _ROW:
        dim = len(shape) - 2
        if dim >= 0 and _shard_dim(shape, dim, msize):
            spec[dim] = "model"
            return P(*spec)

    # fallback: shard the largest divisible dim (skip a small leading stack
    # dim), else replicate
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] >= 4 * msize and _shard_dim(shape, d, msize):
            spec[d] = "model"
            return P(*spec)
    return P(*spec)


def zero1_spec(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Optimizer-state spec: param spec + dp sharding on the largest free dim."""
    dp = dp_axis_names(mesh)
    dsize = axis_size(mesh, dp)
    if dsize == 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    free = [d for d in range(len(shape)) if entries[d] is None]
    free.sort(key=lambda d: -shape[d])
    for d in free:
        if shape[d] % dsize == 0 and shape[d] >= dsize:
            entries[d] = dp if len(dp) > 1 else dp[0]
            break
    return P(*entries)


def param_specs(params, mesh):
    """A tree of specs mirroring a params tree (leaves: anything with a
    ``shape``, meta tensors included)."""
    return _map_with_path(lambda path, leaf: param_spec(path, tuple(leaf.shape), mesh),
                          params)


def opt_specs(params, mesh):
    return _map_with_path(
        lambda path, leaf: zero1_spec(param_spec(path, tuple(leaf.shape), mesh),
                                      tuple(leaf.shape), mesh), params)


# ---------------------------------------------------------------------------
# Batches, caches, logits
# ---------------------------------------------------------------------------


def _dp_entry(mesh, batch: int):
    dp = dp_axis_names(mesh)
    if not dp:
        return None
    dsize = axis_size(mesh, dp)
    if batch % dsize == 0 and batch >= dsize:
        return dp if len(dp) > 1 else dp[0]
    # try the inner data axis alone (multi-pod with a tiny batch)
    if "data" in dp and batch % mesh.shape["data"] == 0 and batch >= mesh.shape["data"]:
        return "data"
    return None


def _seq_entry(mesh, seq: int):
    msize = axis_size(mesh, "model")
    if msize > 1 and seq % msize == 0 and seq >= msize:
        return "model"
    return None


def batch_specs(batch_tree, mesh):
    """Specs for a train/prefill batch dict: dim0 = batch, dim1 = seq."""

    def one(_, leaf):
        spec = [None] * len(leaf.shape)
        spec[0] = _dp_entry(mesh, leaf.shape[0])
        if len(leaf.shape) >= 2:
            spec[1] = _seq_entry(mesh, leaf.shape[1])
        return P(*spec)

    return _map_with_path(one, batch_tree)


def cache_specs(cache_tree, mesh):
    """Decode-cache specs. Leaves are per-layer buffers: KV (B, S, KV, hd),
    seq over ``model``; SSM state (B, H, P, N), heads over ``model``; SSM
    conv (B, K, W), channel width over ``model``; batch over the data axes
    everywhere it divides."""

    def one(_, leaf):
        shape = leaf.shape
        spec = [None] * len(shape)
        spec[0] = _dp_entry(mesh, shape[0])
        if len(shape) == 4:
            # dim1 is seq (KV cache) or heads (SSM state): both shard
            spec[1] = _seq_entry(mesh, shape[1])
        elif len(shape) == 3:
            # SSM conv buffer (B, K, W): shard the channel width
            spec[2] = _seq_entry(mesh, shape[2])
        return P(*spec)

    return _map_with_path(one, cache_tree)


#: Sequence-shard the residual stream at layer boundaries (default), or keep
#: it whole on every rank of a model group (Megatron-classic: an all-reduce
#: after each row-parallel product in place of a reduce-scatter and a
#: gather). ``REPRO_RESIDUAL_SEQ=0``, read at import as in JAX, is the
#: dry-run's A/B knob (``repro_torch.launch.dryrun``).
RESIDUAL_SEQ_SHARD = os.environ.get("REPRO_RESIDUAL_SEQ", "1") != "0"


def residual_constraint(mesh) -> Callable[[Sequence[int]], P]:
    """The residual stream's spec at a layer boundary, (B, S, D) -> spec:
    the sequence over ``model`` where it divides (Megatron-SP), else whole
    on every rank of a model group; always whole when
    :data:`RESIDUAL_SEQ_SHARD` is false."""

    def spec(shape):
        seq = _seq_entry(mesh, shape[1]) if RESIDUAL_SEQ_SHARD else None
        return P(_dp_entry(mesh, shape[0]), seq, None)

    return spec


def qkv_constraint(mesh) -> Callable[[Sequence[int], Sequence[int]], Tuple[P, P]]:
    """Attention's layout (train and prefill), q (B, S, KV, G, hd) and k / v
    (B, S, KV, hd) shapes -> (q spec, k and v spec): head-parallel when the
    KV heads split over ``model`` (q, k, v on the KV-head dim, the sequence
    whole), else sequence-parallel (q's sequence over ``model``, K/V whole:
    gathered once per layer)."""
    msize = axis_size(mesh, "model")

    def spec(q_shape, k_shape):
        b, _, kvh, _ = k_shape
        dp = _dp_entry(mesh, b)
        if msize > 1 and kvh % msize == 0 and kvh >= msize:
            return P(dp, None, "model", None, None), P(dp, None, "model", None)
        return P(dp, _seq_entry(mesh, q_shape[1]), None, None, None), P(dp, None, None, None)

    return spec


def ssm_inner_constraint(mesh) -> Callable[[Sequence[int]], P]:
    """The SSM projection (B, S, W)'s spec: W over ``model`` when it
    divides, the sequence local."""
    msize = axis_size(mesh, "model")

    def spec(shape):
        w = "model" if (msize > 1 and shape[-1] % msize == 0) else None
        return P(_dp_entry(mesh, shape[0]), None, w)

    return spec


def expert_constraint(mesh) -> Callable[[Sequence[int]], P]:
    """The dispatched MoE tensors (E, G, C, D)'s spec: experts over
    ``model`` when they divide, groups over the data axes."""
    msize = axis_size(mesh, "model")

    def spec(shape):
        e = "model" if (msize > 1 and shape[0] % msize == 0) else None
        return P(e, _dp_entry(mesh, shape[1]), None, None)

    return spec


def logits_spec(mesh, batch: int, vocab: int) -> P:
    msize = axis_size(mesh, "model")
    v_entry = "model" if (msize > 1 and vocab % msize == 0) else None
    return P(_dp_entry(mesh, batch), None, v_entry)


# ---------------------------------------------------------------------------
# Blocks of a spec on a mesh with ranks
# ---------------------------------------------------------------------------


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: Sequence[int], spec: P, mesh) -> Tuple[int, ...]:
    """A leaf's block shape under ``spec``: each dim over the product of its
    entry's axis sizes."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(mesh.shape[a] for a in entry_axes(entry))
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split over {entry} ({n})")
        out[d] //= n
    return tuple(out)


def shard(full: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The block of ``full`` that this rank (``mesh.coordinate``) holds
    under ``spec``: along each dim, block number ``sum(coordinate * size of
    the axes after it)`` over the entry's axes, major to minor. A new tensor
    when some dim splits, else ``full`` itself. A dim that does not split
    evenly raises ``ValueError``."""
    shape = local_shape(full.shape, spec, mesh)
    if shape == tuple(full.shape):
        return full
    out = full
    for d, size in enumerate(shape):
        idx = 0
        for a in entry_axes(spec[d]) if d < len(spec) else ():
            idx = idx * mesh.shape[a] + mesh.coordinate(a)
        out = out.narrow(d, idx * size, size)
    return out.clone()


def gather(local: torch.Tensor, spec: P, mesh,
           axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """The full tensor of every rank's ``local`` block under ``spec``,
    all-gathered over the groups of the spec's axes (only ``axes`` when
    given: the block of the spec without them)."""
    out = local
    for d, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):  # minor axis first
            if (axes is not None and a not in axes) or mesh.shape[a] == 1:
                continue
            out = out.contiguous()
            parts = [torch.empty_like(out) for _ in range(mesh.shape[a])]
            dist.all_gather(parts, out, group=mesh.group(a))
            out = torch.cat(parts, dim=d)
    return out


def mean_over(tensors: Sequence[torch.Tensor], mesh, axes: Sequence[str]):
    """The means of ``tensors`` over the ranks of each of ``axes`` in turn
    (axes absent from the mesh or of size 1 are skipped): one fp32
    all-reduce of them all flattened per axis, divided by its size, each
    cast back to its dtype."""
    axes = [a for a in axes if mesh.shape.get(a, 1) > 1]
    if not axes:
        return list(tensors)
    flat = torch.cat([t.float().reshape(-1) for t in tensors])
    for a in axes:
        dist.all_reduce(flat, group=mesh.group(a))
        flat = flat / mesh.shape[a]
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out

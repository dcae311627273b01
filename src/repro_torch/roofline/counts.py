"""Costs of a step counted as it runs: the port's counterpart of
``repro.roofline.hlo``, which reads them from XLA's optimised HLO.

:class:`count` is a ``TorchDispatchMode``: every aten op a step issues
passes through it once, forward and backward, so nothing is weighted by a
trip count (a Python loop runs its body as often as it loops). Per op:

  * FLOPs: the products (mm, bmm, addmm, baddbmm, convolutions, attention)
    by ``torch.utils.flop_counter``'s formulas, which are ``FlopCounterMode``'s:
    2 * prod(output dims) * prod(contracting dims), as ``hlo._dot_flops``;
  * ``ew_flops``: one a float output element of a pointwise op that does
    arithmetic (aten's ``pointwise`` tag, less copies, casts and selects),
    as ``hlo._ELEMENTWISE`` counts;
  * memory bytes: each tensor input read and each output written once; a
    view moves nothing; a gather or index reads and writes its output only,
    and an update of a slice moves its update twice (``hlo._op_mem_bytes``'
    slice rules); an allocation moves nothing, a fill writes its output;
  * collective bytes by kind, with JAX's ring-model multipliers on the
    group of ``n`` ranks the op runs on (``hlo._collective_moved``):
        all-reduce          2 * buffer * (n-1)/n
        all-gather          buffer * (n-1)/n      (buffer = gathered output)
        reduce-scatter      buffer * (n-1)        (buffer = scattered shard)
        all-to-all          buffer * (n-1)/n
        collective-permute  buffer                (a point-to-point send)
    counted where the c10d op is dispatched, which is where every
    collective of the port lands (``tp``'s all-gathers and all-reduces,
    ``sharding.gather`` and ``mean_over``, the halo exchange's sends and
    all-gathers, the int8 compression's all-gathers); a broadcast counts as
    ``buffer * (n-1)/n`` under its own kind;
  * the kernels K1-K6: on fake tensors their wrappers launch nothing and
    report their FLOPs and bytes (``kernels.counts.fake_launch``: inputs
    read and outputs written once, the bound formula of ``chip_smoke.py``);
    K6's FLOPs are products on the tensor cores (``flops``), the stencils'
    and gathers' are arithmetic (``ew_flops``).

With ``sites=True`` every cost is also filed under its source site: the
innermost frame of the port that issued it (``path:line (function)``) and
the op, the counterpart of the HLO's ``op_name`` (``roofline.debug``).
"""

from __future__ import annotations

import collections
import dataclasses
import sys
from typing import Dict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels import counts as _kcounts

_PKG = "repro_torch"
_SKIP_FILES = ("/roofline/counts.py", "/kernels/counts.py")

aten = torch.ops.aten

#: ops that move no bytes besides views: allocations and metadata
_NO_BYTES = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
             aten.new_empty_strided, aten._unsafe_view, aten.lift_fresh,
             aten._local_scalar_dense, aten.sym_size, aten.sym_stride, aten.sym_numel,
             aten.set_, aten.resize_}
#: ops that write their output and read nothing
_FILLS = {aten.zero_, aten.fill_, aten.zeros, aten.ones, aten.full, aten.zeros_like,
          aten.ones_like, aten.full_like, aten.arange, aten.scalar_tensor, aten.new_zeros,
          aten.new_ones, aten.new_full, aten.randn, aten.rand, aten.randint, aten.normal_,
          aten.uniform_, aten.random_}
#: ops that read and write their output only (hlo's ``_SLICE_LIKE``)
_GATHERS = {aten.index_select, aten.gather, aten.index, aten.embedding, aten.take,
            aten.slice_copy, aten.select_copy}
#: ops that write an update into a buffer: 2 x the update (the last tensor
#: argument), as ``dynamic-update-slice``
_UPDATES = {aten.index_put_, aten.index_put, aten.scatter, aten.scatter_,
            aten.scatter_add, aten.scatter_add_, aten.slice_scatter, aten.select_scatter,
            aten.index_copy_, aten.index_copy, aten.index_add_, aten.index_add,
            aten._index_put_impl_}

#: pointwise ops that do no arithmetic (copies, casts, selects): no
#: ``ew_flops`` (JAX's ``_ELEMENTWISE`` has no convert, copy or select)
_NO_ARITHMETIC = {aten.clone, aten._to_copy, aten.copy, aten.copy_, aten.where,
                  aten.masked_fill, aten.masked_fill_, aten.fill, aten.fill_, aten.zero_,
                  aten.lift_fresh_copy, aten.detach_copy, aten.alias_copy}

#: metadata queries, left to the next mode (``FlopCounterMode``'s list)
_METADATA = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
             aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
             aten.is_non_overlapping_and_dense.default, aten.size.default,
             aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
             aten.storage_offset.default, aten.sym_storage_offset.default,
             aten.numel.default, aten.sym_numel.default, aten.dim.default,
             torch.ops.prim.layout.default}

#: c10d op -> (kind, multiplier of the buffer given n ranks)
_COLLECTIVES = {
    "allreduce_": ("all-reduce", lambda n: 2.0 * (n - 1) / n),
    "allreduce_coalesced_": ("all-reduce", lambda n: 2.0 * (n - 1) / n),
    "allgather_": ("all-gather", lambda n: (n - 1) / n),
    "_allgather_base_": ("all-gather", lambda n: (n - 1) / n),
    "allgather_into_tensor_coalesced_": ("all-gather", lambda n: (n - 1) / n),
    "reduce_scatter_": ("reduce-scatter", lambda n: float(n - 1)),
    "_reduce_scatter_base_": ("reduce-scatter", lambda n: float(n - 1)),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", lambda n: float(n - 1)),
    "alltoall_": ("all-to-all", lambda n: (n - 1) / n),
    "alltoall_base_": ("all-to-all", lambda n: (n - 1) / n),
    "send": ("collective-permute", lambda n: 1.0),
    "broadcast_": ("broadcast", lambda n: (n - 1) / n),
}


@dataclasses.dataclass
class Costs:
    """JAX's ``hlo.Costs``: dot FLOPs, float elementwise FLOPs, memory bytes
    and collective bytes (by kind) of one rank."""

    flops: float = 0.0
    ew_flops: float = 0.0
    mem_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, other: "Costs", mult: float = 1.0) -> "Costs":
        self.flops += mult * other.flops
        self.ew_flops += mult * other.ew_flops
        self.mem_bytes += mult * other.mem_bytes
        self.coll_bytes += mult * other.coll_bytes
        for k, v in other.coll_by_kind.items():
            self.coll_by_kind[k] = self.coll_by_kind.get(k, 0.0) + mult * v
        return self

    def add_coll(self, kind: str, moved: float) -> None:
        self.coll_bytes += moved
        self.coll_by_kind[kind] = self.coll_by_kind.get(kind, 0.0) + moved


def tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


def _group_size(args) -> int:
    for a in tree_flatten(list(args))[0]:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except (RuntimeError, TypeError):
                continue
    return 2


def _op_bytes(func, args, kwargs, out) -> float:
    packet = func._overloadpacket
    if func.is_view or packet in _NO_BYTES or not tensor_bytes(out):
        return 0.0
    if packet in _FILLS:
        return float(tensor_bytes(out))
    if packet in _GATHERS:
        return 2.0 * tensor_bytes(out)
    if packet in _UPDATES:
        tensors = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        return 2.0 * tensor_bytes(tensors[-1]) if tensors else 0.0
    if packet is aten.copy_:
        return float(tensor_bytes(args[0]) + tensor_bytes(args[1]))
    return float(tensor_bytes((args, kwargs)) + tensor_bytes(out))


def _is_float(out) -> bool:
    leaves = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    return bool(leaves) and all(t.is_floating_point() for t in leaves)


def site(op: str) -> str:
    """The innermost frame of the port above the counting code, with ``op``;
    in backward, the frame that asked for the gradients and the autograd
    node that runs (``MmBackward0``, ...)."""
    node = torch._C._current_autograd_node()
    if node is not None:
        op = f"{node.name()} {op}"
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename.replace("\\", "/")
        if f"/{_PKG}/" in name and not name.endswith(_SKIP_FILES):
            rel = name.split(f"/{_PKG}/", 1)[1]
            return f"{rel}:{f.f_lineno} ({f.f_code.co_name}) {op}"
        f = f.f_back
    return f"<outside the port> {op}"


class count(TorchDispatchMode):
    """Counts the :class:`Costs` of the ops run inside it into ``costs``
    (and ``by_site`` with ``sites=True``); ``kernels`` holds the kernels'
    fake launches by name: ``{"launches", "flops", "bytes"}``."""

    def __init__(self, sites: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.costs = Costs()
        self.sites = sites
        self.by_site: Dict[str, Costs] = collections.defaultdict(Costs)
        self.kernels: Dict[str, Dict[str, float]] = {}

    def __enter__(self):
        # re-entered to run a decomposition (below): one listener throughout
        self._depth = getattr(self, "_depth", 0) + 1
        if self._depth == 1:
            _kcounts.add_listener(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            _kcounts.remove_listener(self._kernel)
        return super().__exit__(*exc)

    def _file(self, c: Costs, op: str) -> None:
        self.costs.add(c)
        if self.sites:
            self.by_site[site(op)].add(c)

    def _kernel(self, name: str, flops: float, nbytes: float, tensor_core: bool) -> None:
        k = self.kernels.setdefault(name, dict(launches=0, flops=0.0, bytes=0.0))
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        c = Costs(mem_bytes=nbytes)
        if tensor_core:
            c.flops = flops
        else:
            c.ew_flops = flops
        self._file(c, f"kernel {name}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        # A composite op (einsum, matmul, linear: under inference mode they
        # reach a mode whole) is counted as the ops it decomposes into, as
        # ``FlopCounterMode`` does.
        if func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            name = func._overloadpacket.__name__
            if name in _COLLECTIVES:
                kind, mult = _COLLECTIVES[name]
                c = Costs()
                c.add_coll(kind, tensor_bytes(args[0]) * mult(_group_size(args)))
                self._file(c, f"c10d.{name}")
            return out
        packet = func._overloadpacket
        c = Costs(mem_bytes=_op_bytes(func, args, kwargs, out))
        if packet in self._flop_registry:
            c.flops = float(self._flop_registry[packet](*args, **kwargs, out_val=out))
        elif (torch.Tag.pointwise in func.tags and packet not in _NO_ARITHMETIC
              and _is_float(out)):
            c.ew_flops = float(sum(t.numel() for t in tree_flatten(out)[0]
                                   if isinstance(t, torch.Tensor)))
        if c.flops or c.ew_flops or c.mem_bytes:
            self._file(c, str(packet))
        return out


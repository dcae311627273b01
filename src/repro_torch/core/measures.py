"""Distance measures D(m(.,1), m1) (port of ``repro.core.measures``, SSD).

The solver touches D through three quantities: ``value`` (the mismatch part
of J), ``terminal_adjoint`` (lambda(1) = -dD/dm(1)) and ``gn_terminal``
(lt(1) = -H_D mt(1), the Gauss-Newton terminal of the incremental adjoint).
Only SSD is ported; NCC and NGF are queued (ROADMAP A12) and raise. The
reductions honour ``cfg.shard`` (slab-parallel solve: all-reduced inner
products over the global grid).
"""

from __future__ import annotations

import dataclasses

import torch

from . import grid as _grid


def _domain_mean(f: torch.Tensor, shard=None) -> torch.Tensor:
    """Mean of a scalar field over the (global) domain; all-reduced when
    sharded."""
    shape = tuple(f.shape[-3:])
    if shard is not None:
        shape = shard.global_shape(shape)
    vol = _grid.cell_volume(shape) * float(shape[0] * shape[1] * shape[2])
    return _grid.inner(f, torch.ones_like(f), shard=shard) / vol


class DistanceMeasure:
    """Interface consumed by objective/gradient/hessian."""

    name: str = "?"

    def value(self, m_final, m1, cfg) -> torch.Tensor:
        """D(m_final, m1) — the mismatch part of the objective."""
        raise NotImplementedError

    def terminal_adjoint(self, m_final, m1, cfg) -> torch.Tensor:
        """lambda(1) = -dD/dm(1) (L2 functional derivative)."""
        raise NotImplementedError

    def make_cache(self, m_final, m1, cfg):
        """Per-Newton-step terminal cache consumed by :meth:`gn_terminal`
        (``None`` when the measure needs none)."""
        return None

    def gn_terminal(self, mt1, m_final, m1, cfg, cache=None) -> torch.Tensor:
        """lt(1) = -H_D mt(1) for the incremental (GN) adjoint solve."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SSD(DistanceMeasure):
    """D = 0.5 ||m_f - m1||^2_L2;  lambda(1) = m1 - m_f,  lt(1) = -mt(1)."""

    name = "ssd"

    def value(self, m_final, m1, cfg):
        r = m_final - m1
        return 0.5 * _grid.inner(r, r, shard=cfg.shard)

    def terminal_adjoint(self, m_final, m1, cfg):
        return m1 - m_final

    def gn_terminal(self, mt1, m_final, m1, cfg, cache=None):
        return -mt1


_REGISTRY = {"ssd": SSD()}
_QUEUED = ("ncc", "ngf")


def available() -> tuple:
    """Measure names accepted as config strings."""
    return tuple(sorted(_REGISTRY))


def resolve(spec) -> DistanceMeasure:
    """Map a measure spec (name, instance or None) to a
    :class:`DistanceMeasure`."""
    if isinstance(spec, DistanceMeasure):
        return spec
    if spec is None:
        return _REGISTRY["ssd"]
    key = str(spec).lower()
    if key in _QUEUED:
        raise NotImplementedError(
            f"distance measure {spec!r} is not ported yet (ROADMAP A12)")
    try:
        return _REGISTRY[key]
    except KeyError:
        raise ValueError(
            f"unknown distance measure {spec!r}; expected one of "
            f"{available()} or a DistanceMeasure instance") from None

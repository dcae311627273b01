"""Distance measures D(m(.,1), m1) (port of ``repro.core.measures``).

The solver touches D through three quantities: ``value`` (the mismatch part
of J), ``terminal_adjoint`` (lambda(1) = -dD/dm(1)) and ``gn_terminal``
(lt(1) = -H_D mt(1), the Gauss-Newton terminal of the incremental adjoint).
``make_cache`` builds, once per gradient evaluation, what ``gn_terminal``
needs at that iterate; it rides in ``GradientState.measure_cache``.

SSD     D = 0.5 ||m_f - m1||^2;  lambda(1) = m1 - m_f,  lt(1) = -mt(1).
NCC     D = 1 - a^2/(bc), a = <f,g>, b = ||f||^2, c = ||g||^2 with f, g the
        zero-mean images: lambda(1) = (2a/(bc)) (g - (a/b) f),
        H_gn u = (2a^2/(b^2 c)) P (u - (<g,u>/c) g).
NGF     D = mean of 1 - <p,q>^2 / ((|p|^2+eps_f^2)(|q|^2+eps_g^2)) with
        p = grad m_f, q = grad m1: lambda(1) = div(w), H_gn = -div(A grad .)
        with A pointwise PSD; the edge parameters are estimated from the
        images and held constant (``detach``).

The expressions keep the JAX package's order of operations and keep the
scalar moments as 0-d tensors, so fp32 results agree with it to rounding.
The reductions honour ``cfg.shard`` (slab-parallel solve: all-reduced inner
products over the global grid), and NGF's ``grad``/``div`` take the halo
operators there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import derivatives as _deriv
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


@dataclasses.dataclass(frozen=True)
class _NCCCache:
    g: torch.Tensor      # zero-mean reference image P m1
    a: torch.Tensor      # <f, g>
    b: torch.Tensor      # ||f||^2 (guarded)
    c: torch.Tensor      # ||g||^2 (guarded)


@dataclasses.dataclass(frozen=True)
class NCC(DistanceMeasure):
    """Squared normalized cross-correlation (global, zero-mean): invariant to
    affine intensity changes of either image. ``eps`` guards the norms of
    (near-)constant images."""

    eps: float = 1e-12

    name = "ncc"

    def _moments(self, m_final, m1, cfg):
        shard = cfg.shard
        f = m_final - _domain_mean(m_final, shard)
        g = m1 - _domain_mean(m1, shard)
        a = _grid.inner(f, g, shard=shard)
        b = torch.clamp(_grid.inner(f, f, shard=shard), min=self.eps)
        c = torch.clamp(_grid.inner(g, g, shard=shard), min=self.eps)
        return f, g, a, b, c

    def value(self, m_final, m1, cfg):
        _, _, a, b, c = self._moments(m_final, m1, cfg)
        return 1.0 - (a * a) / (b * c)

    def terminal_adjoint(self, m_final, m1, cfg):
        f, g, a, b, c = self._moments(m_final, m1, cfg)
        # f and g are zero-mean, so the projection of the variation drops out.
        return (2.0 * a / (b * c)) * (g - (a / b) * f)

    def make_cache(self, m_final, m1, cfg):
        _, g, a, b, c = self._moments(m_final, m1, cfg)
        return _NCCCache(g=g, a=a, b=b, c=c)

    def gn_terminal(self, mt1, m_final, m1, cfg, cache=None):
        if cache is None:
            cache = self.make_cache(m_final, m1, cfg)
        g, a, b, c = cache.g, cache.a, cache.b, cache.c
        u = mt1 - _domain_mean(mt1, cfg.shard)
        gu = _grid.inner(g, u, shard=cfg.shard)
        h = (2.0 * a * a / (b * b * c)) * (u - (gu / c) * g)
        return -h


#: NGF is the domain-*mean* misalignment density (the integral over
#: |Omega| = (2 pi)^3), so D and the beta that balances it live on the scale
#: of SSD and NCC.
_NGF_NORM = 1.0 / _grid.TWO_PI ** 3


@dataclasses.dataclass(frozen=True)
class _NGFCache:
    kappa: torch.Tensor  # 2 r^2 / (np2^2 nq2), the GN density coefficient
    q: torch.Tensor      # grad m1 (3, N1, N2, N3)
    nq2: torch.Tensor    # |q|^2 + eps_g^2


@dataclasses.dataclass(frozen=True)
class NGF(DistanceMeasure):
    """Normalized gradient fields: aligns edge orientation whatever the
    intensity mapping (multi-modal pairs). ``eps`` fixes the edge parameter;
    ``None`` estimates it per image as ``eps_rel * mean |grad m|``."""

    eps: Optional[float] = None
    eps_rel: float = 0.1

    name = "ngf"

    def _grad(self, m, cfg):
        return _deriv.grad(m, scheme=cfg.deriv, shard=cfg.shard)

    def _div(self, w, cfg):
        return _deriv.div(w, scheme=cfg.deriv, shard=cfg.shard)

    def _edge_eps(self, p, cfg):
        if self.eps is not None:
            return torch.tensor(self.eps, dtype=p.dtype, device=p.device)
        gmag = torch.sqrt(torch.sum(p * p, dim=0))
        est = self.eps_rel * _domain_mean(gmag, cfg.shard) + 1e-8
        # A data-derived constant of the measure, not part of the functional
        # being differentiated (``stop_gradient`` in JAX).
        return est.detach()

    def _fields(self, m_final, m1, cfg):
        p = self._grad(m_final, cfg)
        q = self._grad(m1, cfg)
        eps_f = self._edge_eps(p, cfg)
        eps_g = self._edge_eps(q, cfg)
        r = torch.sum(p * q, dim=0)
        np2 = torch.sum(p * p, dim=0) + eps_f * eps_f
        nq2 = torch.sum(q * q, dim=0) + eps_g * eps_g
        return p, q, r, np2, nq2

    def value(self, m_final, m1, cfg):
        _, _, r, np2, nq2 = self._fields(m_final, m1, cfg)
        dens = 1.0 - (r * r) / (np2 * nq2)
        return _NGF_NORM * _grid.inner(dens, torch.ones_like(dens), shard=cfg.shard)

    def terminal_adjoint(self, m_final, m1, cfg):
        p, q, r, np2, nq2 = self._fields(m_final, m1, cfg)
        # lambda(1) = div(dphi/dp), phi(p) = 1 - r^2/(np2*nq2) pointwise.
        w = (_NGF_NORM * 2.0 * r / (np2 * nq2)) * ((r / np2) * p - q)
        return self._div(w, cfg)

    def make_cache(self, m_final, m1, cfg):
        _, q, r, np2, nq2 = self._fields(m_final, m1, cfg)
        kappa = _NGF_NORM * 2.0 * (r * r) / (np2 * np2 * nq2)
        return _NGFCache(kappa=kappa, q=q, nq2=nq2)

    def gn_terminal(self, mt1, m_final, m1, cfg, cache=None):
        if cache is None:
            cache = self.make_cache(m_final, m1, cfg)
        u = self._grad(mt1, cfg)
        qu = torch.sum(cache.q * u, dim=0)
        au = cache.kappa * (u - cache.q * (qu / cache.nq2))
        # lt(1) = -H mt(1) = div(A grad mt).
        return self._div(au, cfg)


_REGISTRY = {"ssd": SSD(), "ncc": NCC(), "ngf": NGF()}


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
    try:
        return _REGISTRY[key]
    except KeyError:
        raise ValueError(
            f"unknown distance measure {spec!r}; expected one of "
            f"{available()} or a DistanceMeasure instance") from None

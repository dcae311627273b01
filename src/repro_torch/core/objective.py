"""Objective functional (1a): distance measure + H1-div regularization (port
of ``repro.core.objective``)."""

from __future__ import annotations

import torch

from . import grid as _grid
from . import measures as _meas
from . import spectral as _spec
from . import transport as _tr


def mismatch(m_final: torch.Tensor, m1: torch.Tensor, shard=None) -> torch.Tensor:
    """0.5 * || m(.,1) - m1 ||_L2^2 (global; all-reduced when sharded)."""
    r = m_final - m1
    return 0.5 * _grid.inner(r, r, shard=shard)


def relative_mismatch(m_final: torch.Tensor, m1: torch.Tensor,
                      m0: torch.Tensor) -> torch.Tensor:
    """||m(.,1)-m1||_2 / ||m1 - m0||_2, and 0.0 for an identical pair (0/0)."""
    num = _grid.norm_l2(m_final - m1)
    den = _grid.norm_l2(m1 - m0)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def objective(m0: torch.Tensor, m1: torch.Tensor, v: torch.Tensor, beta: float,
              gamma: float, cfg: _tr.TransportConfig,
              foot: torch.Tensor | None = None, plan=None) -> torch.Tensor:
    """J(v) per eq. (1a); solves the state equation internally."""
    m_traj = _tr.solve_state(m0, v, cfg, foot=foot, plan=plan)
    meas = _meas.resolve(cfg.measure)
    return (meas.value(m_traj[-1], m1, cfg)
            + _spec.reg_energy(v, beta, gamma, shard=cfg.shard))

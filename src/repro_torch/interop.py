"""Carry the JAX package's state across into the port, through numpy.

The registration system has no weights; its state is the velocity ``v`` (the
warm start of a served subject), the interpolation plans and the
``GradientState`` of a Newton step. These functions take that state as numpy
arrays (or anything ``numpy.asarray`` reads) and return the port's tensors
and dataclasses, so a test can feed one package's state to the other.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from . import device as _device
from .core import gradient as _grad
from .core import interp as _interp

_PLAN_FIELDS = ("plan_fwd", "plan_adj")


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """A contiguous tensor on ``device`` with the array's own dtype."""
    return _device.as_tensor(a, _device.resolve(device), dtype=None)


def plan_from_numpy(idx, weights, method: str, field_shape,
                    device="cuda") -> _interp.InterpPlan:
    """An :class:`~repro_torch.core.interp.InterpPlan` from per-axis index and
    weight arrays ``(S, *out_shape)``; indices become int32."""
    if len(idx) != 3 or len(weights) != 3:
        raise ValueError("a plan has three index and three weight arrays")
    idx_t = tuple(tensor_from_numpy(np.asarray(i).astype(np.int32), device)
                  for i in idx)
    w_t = tuple(tensor_from_numpy(w, device) for w in weights)
    return _interp.InterpPlan(idx_t, w_t, method, tuple(int(n) for n in field_shape))


def _plan_from(obj, device):
    if obj is None:
        return None
    if isinstance(obj, Mapping):
        return plan_from_numpy(obj["idx"], obj["weights"], obj["method"],
                               obj["field_shape"], device)
    return plan_from_numpy(obj.idx, obj.weights, obj.method, obj.field_shape,
                           device)


def gradient_state_from_numpy(state: Mapping, device="cuda") -> _grad.GradientState:
    """A :class:`~repro_torch.core.gradient.GradientState` from a mapping of
    its fields. Array fields are numpy arrays; each plan is a mapping with
    ``idx, weights, method, field_shape`` or an object with those attributes
    (such as the JAX ``InterpPlan``). Only SSD states (``measure_cache``
    None) are ported."""
    if state.get("measure_cache") is not None:
        raise NotImplementedError(
            "measure caches (NCC/NGF) are not ported yet (ROADMAP A12)")
    kwargs = {}
    for f in ("g", "m_traj", "lam_traj", "foot_fwd", "foot_adj", "divv",
              "j_mismatch", "j_reg", "grad_m_traj"):
        val = state.get(f)
        kwargs[f] = None if val is None else tensor_from_numpy(val, device)
    for f in _PLAN_FIELDS:
        kwargs[f] = _plan_from(state.get(f), device)
    return _grad.GradientState(**kwargs)

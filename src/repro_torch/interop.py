"""Carry the JAX package's state across into the port, through numpy.

The registration system has no weights; its state is the velocity ``v`` (the
warm start of a served subject), the interpolation plans and the
``GradientState`` of a Newton step. These functions take that state as numpy
arrays (or anything ``numpy.asarray`` reads) and return the port's tensors
and dataclasses, so a test can feed one package's state to the other.
``slab_split``/``slab_join`` cut a global array into the x1 slabs of the
slab-parallel solve and join them back. ``lm_params_from_jax`` carries an LM's
params pytree across as the state dict of ``repro_torch.models.Model``, and
``train_state_from_jax`` a JAX ``TrainState`` as the port's.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from . import device as _device
from .core import gradient as _grad
from .core import interp as _interp
from .core import measures as _meas

_PLAN_FIELDS = ("plan_fwd", "plan_adj")


def slab_split(a, rank: int, nshards: int) -> np.ndarray:
    """Rank ``rank``'s x1 slab (axis -3) of a global array cut into
    ``nshards`` equal slabs, as the slab-parallel solve cuts its fields."""
    a = np.asarray(a)
    n1 = a.shape[-3]
    if n1 % nshards:
        raise ValueError(f"x1 extent {n1} not divisible by {nshards} slabs")
    n_loc = n1 // nshards
    return a[..., rank * n_loc:(rank + 1) * n_loc, :, :]


def slab_join(slabs) -> np.ndarray:
    """The global array of per-rank x1 slabs given in rank order."""
    return np.concatenate([np.asarray(s) for s in slabs], axis=-3)


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """A contiguous tensor on ``device`` with the array's own dtype."""
    return _device.as_tensor(a, _device.resolve(device), dtype=None)


def _weights_from_numpy(w, device) -> torch.Tensor:
    """A weight array as a tensor; bfloat16 arrays (JAX's, typed by
    ``ml_dtypes``, which torch cannot read) are read as float32, which holds
    every bf16 value exactly, and cast back to ``torch.bfloat16``."""
    w = np.asarray(w)
    if w.dtype.name == "bfloat16":
        return tensor_from_numpy(np.asarray(w, dtype=np.float32), device).to(
            torch.bfloat16)
    return tensor_from_numpy(w, device)


def plan_from_numpy(idx, weights, method: str, field_shape,
                    device="cuda") -> _interp.InterpPlan:
    """An :class:`~repro_torch.core.interp.InterpPlan` from per-axis index and
    weight arrays ``(S, *out_shape)``; indices become int32, weights keep
    their dtype (float32 or bfloat16)."""
    if len(idx) != 3 or len(weights) != 3:
        raise ValueError("a plan has three index and three weight arrays")
    idx_t = tuple(tensor_from_numpy(np.asarray(i).astype(np.int32), device)
                  for i in idx)
    w_t = tuple(_weights_from_numpy(w, device) for w in weights)
    return _interp.InterpPlan(idx_t, w_t, method, tuple(int(n) for n in field_shape))


def _plan_from(obj, device):
    if obj is None:
        return None
    if isinstance(obj, Mapping):
        return plan_from_numpy(obj["idx"], obj["weights"], obj["method"],
                               obj["field_shape"], device)
    return plan_from_numpy(obj.idx, obj.weights, obj.method, obj.field_shape,
                           device)


#: measure cache type -> its fields, as both packages name them
_CACHES = {_meas._NCCCache: ("g", "a", "b", "c"),
           _meas._NGFCache: ("kappa", "q", "nq2")}


def measure_cache_from_numpy(cache, device="cuda"):
    """An NCC or NGF measure cache (``measures._NCCCache`` /
    ``_NGFCache``) from a mapping of its fields or an object with them as
    attributes (such as the JAX NamedTuples); None stays None (SSD)."""
    if cache is None:
        return None
    get = cache.get if isinstance(cache, Mapping) else (
        lambda k: getattr(cache, k, None))
    for typ, fields in _CACHES.items():
        vals = [get(k) for k in fields]
        if all(v is not None for v in vals):
            return typ(*(tensor_from_numpy(v, device) for v in vals))
    raise ValueError("a measure cache has the fields of NCC (g, a, b, c) or of NGF "
                     f"(kappa, q, nq2); got {cache!r:.80}")


def gradient_state_from_numpy(state: Mapping, device="cuda") -> _grad.GradientState:
    """A :class:`~repro_torch.core.gradient.GradientState` from a mapping of
    its fields. Array fields are numpy arrays; each plan is a mapping with
    ``idx, weights, method, field_shape`` or an object with those attributes
    (such as the JAX ``InterpPlan``); the measure cache is None (SSD) or an
    NCC / NGF cache as :func:`measure_cache_from_numpy` takes it."""
    kwargs = {}
    for f in ("g", "m_traj", "lam_traj", "foot_fwd", "foot_adj", "divv",
              "j_mismatch", "j_reg", "grad_m_traj"):
        val = state.get(f)
        kwargs[f] = None if val is None else tensor_from_numpy(val, device)
    for f in _PLAN_FIELDS:
        kwargs[f] = _plan_from(state.get(f), device)
    kwargs["measure_cache"] = measure_cache_from_numpy(state.get("measure_cache"), device)
    return _grad.GradientState(**kwargs)


def lm_params_from_jax(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """The state dict of ``repro_torch.models.Model(cfg)`` (CPU tensors) from
    the JAX ``Model.init`` params pytree of any family, leaves as numpy
    arrays (bfloat16 ones typed by ``ml_dtypes``).

    The leaves become tensors as they are; the layout (JAX's segment leaves
    stacked over their repeats, one state-dict entry per layer in the port;
    the encoder's too) is ``models.api.state_dict_from_tree``'s. Dense
    weights keep JAX's ``(d_in, d_out)`` layout, expert weights their
    ``(e, d, f)``. The embedding table has ``cfg.vocab_padded`` rows (e.g.
    Qwen1.5's 151 936 tokens padded to 152 064); ``unembed`` exists only
    without tied embeddings, QKV biases only with ``cfg.qkv_bias``; the SSM
    leaves ``A_log``, ``D`` and ``dt_bias`` are fp32.
    """
    # imported here: the models package loads the K6 wrapper, which the
    # registration side of this module does not need
    from .models import api

    def tensors(tree):
        if isinstance(tree, Mapping):
            return {k: tensors(v) for k, v in tree.items()}
        return _weights_from_numpy(tree, "cpu")

    return api.state_dict_from_tree(tensors(params), cfg)


def train_state_from_jax(state, cfg, device="cuda"):
    """The port's ``repro_torch.train.steps.TrainState`` on ``device`` from a
    JAX ``TrainState(params, opt)`` of ``cfg``'s model, leaves as numpy
    arrays (bfloat16 ones typed by ``ml_dtypes``).

    Both packages keep the params and the AdamW ``m``, ``v`` and ``master``
    trees in the JAX layout (each segment's leaves stacked over its repeats),
    so the leaves come across as they are; each of the four trees is checked
    against ``cfg`` as ``lm_params_from_jax`` checks params. ``opt["step"]``
    stays a 0-d int32 tensor."""
    from .models import api
    from .train.steps import TrainState

    def tensors(tree):
        if isinstance(tree, Mapping):
            return {k: tensors(v) for k, v in tree.items()}
        return _weights_from_numpy(tree, device)

    params, opt = state
    out = TrainState(tensors(params), {k: tensors(opt[k]) for k in ("m", "v", "master")})
    for tree in (out.params, *out.opt.values()):
        api.layers_from_tree(tree, cfg)
    out.opt["step"] = tensor_from_numpy(np.asarray(opt["step"], dtype=np.int32), device)
    return out

"""AdamW with fp32 master weights beside the params (port of
``repro.optim.adamw``).

The optimizer state per leaf is ``m``, ``v`` and ``master``, all fp32, in the
params tree's layout, and an int32 ``step``. An update reads the gradients
(bf16 for bf16 params), clips them by their global norm, runs fp32 math on
the master copy and returns new params cast to each leaf's dtype. The
schedule and every product run in fp32 in JAX's order; trees are nested
dicts and lists of tensors, taken leaf by leaf in JAX's order (dict keys
sorted), which the global norm's sum follows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def leaves(tree) -> List[torch.Tensor]:
    """The leaves of a tree of dicts and lists in JAX's order
    (``jax.tree.leaves``: dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def unflatten(like, flat):
    """A tree of ``like``'s structure whose leaves are ``flat``, given in
    :func:`leaves` order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, list):
            return [build(x) for x in t]
        return next(it)

    return build(like)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr`` over ``warmup_steps``, then a half cosine
    to 0 at ``total_steps``; an fp32 0-d tensor on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / float(max(cfg.warmup_steps, 1)), max=1.0)
    t = torch.clamp((step - float(cfg.warmup_steps))
                    / float(max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def adamw_init(params) -> Dict[str, Any]:
    """Zero fp32 ``m`` and ``v``, an fp32 ``master`` copy and step 0 (int32,
    on the first leaf's device)."""
    flat = leaves(params)

    def zeros():
        return unflatten(params, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                  for p in flat])

    return {
        "m": zeros(),
        "v": zeros(),
        "master": unflatten(params, [p.detach().to(torch.float32, copy=True) for p in flat]),
        "step": torch.zeros((), dtype=torch.int32, device=flat[0].device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the fp32 sums of squares of the leaves, added in JAX's leaf
    order."""
    sq = sum(torch.sum(torch.square(g.float())) for g in leaves(tree))
    return torch.sqrt(sq)


def adamw_update(cfg: AdamWConfig, grads, opt_state, params, gnorm=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new optimizer state, {"grad_norm",
    "lr"}). The gradients are scaled by ``min(1, grad_clip / max(gnorm,
    1e-9))``; the moments are bias-corrected with the incremented step; the
    weight decay applies to every leaf, norms and biases included. ``gnorm``
    is the global norm of the whole gradient tree where ``grads``, the state
    and ``params`` (read for its dtypes) are blocks of it (a sharded step);
    by default it is that of ``grads``."""
    step = opt_state["step"] + 1
    lr = cosine_schedule(cfg, step)

    if gnorm is None:
        gnorm = global_norm(grads)
    # a true division (a Python number / a tensor multiplies by a reciprocal)
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip) / torch.clamp(gnorm, min=1e-9),
                        max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(g, m, v, master):
        g32 = g.float() * scale
        m_new = b1 * m + (1.0 - b1) * g32
        v_new = b2 * v + (1.0 - b2) * g32 * g32
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * master
        return m_new, v_new, master - lr * delta

    out = [upd(g, m, v, w) for g, m, v, w in zip(
        leaves(grads), leaves(opt_state["m"]), leaves(opt_state["v"]),
        leaves(opt_state["master"]))]
    new_m = unflatten(grads, [o[0] for o in out])
    new_v = unflatten(grads, [o[1] for o in out])
    new_master = unflatten(grads, [o[2] for o in out])
    new_params = unflatten(grads, [o[2].to(p.dtype) for o, p in zip(out, leaves(params))])
    new_state = {"m": new_m, "v": new_v, "master": new_master, "step": step}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}

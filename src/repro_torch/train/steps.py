"""The train step (port of ``repro.train.steps``' training half).

A :class:`TrainState` holds the params and the AdamW state as trees in the
JAX layout (each decoder and encoder segment's leaves stacked over its
repeats), on the model's device: a checkpoint of it is the JAX package's,
leaf for leaf. ``make_train_step`` returns the step: the loss and its
gradients through autograd (``Model.loss`` on leaves that require grad),
then ``adamw_update``. Sharding waits for ROADMAP A20.4: the step runs on
one device, the model's, and a mesh of more than one device raises.
"""

from __future__ import annotations

import math
import os
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ..models import api as _api
from ..models import attention as _attn
from ..optim import adamw
from ..optim.adamw import AdamWConfig


class TrainState(NamedTuple):
    params: Any
    opt: Dict[str, Any]


def _check_mesh(mesh) -> None:
    """``mesh``: None or a mesh shape of one device; anything larger raises."""
    if mesh is not None and math.prod(mesh) != 1:
        raise NotImplementedError(f"a {tuple(mesh)} mesh: sharded training is not ported "
                                  "yet (ROADMAP A20.4); the port trains on one device")


def init_train_state(model, generator: Optional[torch.Generator] = None,
                     opt_cfg: AdamWConfig = AdamWConfig()) -> TrainState:
    """Random weights (``Model.init(generator)``, which the model keeps too)
    as a params tree in the JAX layout, and a fresh AdamW state."""
    params = _api.tree_from_layers(model.init(generator).params())
    return TrainState(params, adamw.adamw_init(params))


def abstract_train_state(model) -> TrainState:
    """A train state of ``meta`` tensors with every leaf's shape and dtype:
    the target a checkpoint is restored into."""
    layers = model.params()
    meta = adamw.unflatten(layers, [torch.empty_like(t, device="meta")
                                    for t in adamw.leaves(layers)])
    params = _api.tree_from_layers(meta)
    return TrainState(params, adamw.adamw_init(params))


def _split(batch, k: int):
    """``batch`` cut into ``k`` microbatches along the batch axis."""
    for name, x in batch.items():
        if x.shape[0] % k:
            raise ValueError(f"batch[{name!r}]: {x.shape[0]} rows do not split into "
                             f"{k} microbatches")
    return [{name: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i]
             for name, x in batch.items()} for i in range(k)]


def make_train_step(model, mesh=None, opt_cfg: AdamWConfig = AdamWConfig()) -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` on the model's device,
    metrics ``loss``, ``xent``, ``aux``, ``grad_norm`` and ``lr`` (0-d
    tensors). ``REPRO_MICROBATCH=k`` (read here) accumulates the fp32
    gradients of ``k`` microbatches, as in JAX, where ``xent`` then holds the
    mean total loss. ``REPRO_SCORE_BF16=1`` (read at each step) computes the
    attention scores in bf16."""
    _check_mesh(mesh)
    microbatches = int(os.environ.get("REPRO_MICROBATCH", "0")) or 1
    dev = model.dev

    def loss_and_grads(params, batch):
        flat = adamw.leaves(params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        if os.environ.get("REPRO_SCORE_BF16") == "1":
            _attn.set_block_config(score_dtype=torch.bfloat16)
        try:
            with torch.enable_grad():
                total, metrics = model.loss(batch, adamw.unflatten(params, leaves))
                grads = torch.autograd.grad(total, leaves, materialize_grads=True)
        finally:
            _attn.reset_block_config()
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    def train_step(state: TrainState, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if microbatches <= 1:
            loss, metrics, grads = loss_and_grads(state.params, batch)
        else:
            k = microbatches
            acc, loss_sum, aux_sum = None, 0.0, 0.0
            for mb in _split(batch, k):
                loss_i, metrics_i, grads_i = loss_and_grads(state.params, mb)
                acc = ([g.float() for g in grads_i] if acc is None
                       else [a + g.float() for a, g in zip(acc, grads_i)])
                loss_sum = loss_sum + loss_i
                aux_sum = aux_sum + metrics_i["aux"]
            grads = [a / k for a in acc]
            loss = loss_sum / k
            metrics = {"aux": aux_sum / k, "xent": loss}
        new_params, new_opt, opt_metrics = adamw.adamw_update(
            opt_cfg, adamw.unflatten(state.params, grads), state.opt, state.params)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return TrainState(new_params, new_opt), metrics

    return train_step

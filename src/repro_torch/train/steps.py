"""The train, prefill and decode steps (port of ``repro.train.steps``).

A :class:`TrainState` holds the params and the AdamW state as trees in the
JAX layout (each decoder and encoder segment's leaves stacked over its
repeats): a checkpoint of it is the JAX package's, leaf for leaf.
``make_train_step(model, mesh)`` returns the step: the loss and its
gradients through autograd (``Model.loss`` on leaves that require grad),
then ``adamw_update``.

The step runs on a mesh (:func:`resolve_mesh`): one device is an abstract
(1, 1) mesh over (``data``, ``model``), as in JAX's launcher, on which
every spec is empty and no collective runs. On a mesh with ranks
(``repro_torch.launch.mesh.make_mesh`` inside a ``torch.distributed``
world) each rank stores the blocks that JAX's sharding rules give it
(:func:`state_specs`): bf16 params by ``param_specs`` (over ``model``), the
AdamW ``m``, ``v`` and ``master`` by ``opt_specs`` (ZeRO-1: also over the
data axes), ``step`` replicated. A step takes the rank's rows of the global
batch (``batch_specs``' dim 0) and runs the loss on its param blocks with
the mesh's model group active (``repro_torch.distributed.tp``): the ranks
of a model group split the compute along JAX's four activation rules, each
using a stored block where the compute needs exactly it and gathering the
leaf where it does not. Backward leaves each rank its blocks' gradients (a
gathered leaf's come out of the gather's reduce-scatter); the gradients of
the leaves stored whole are shares, all-reduced over ``model``. Then the
gradients and metrics are averaged over the data axes, the grad norm is
the model group's all-reduced sum of squares (each leaf stored whole counted
once), each rank updates its opt-spec blocks and the new bf16 master blocks
are all-gathered over the data axes back into the param layout.

:func:`make_prefill_step` and :func:`make_decode_step` (JAX's
``make_prefill_step`` / ``make_decode_step``) serve on the same blocks:
the params as ``param_specs`` gives them, the decode cache as
``cache_specs`` does (:func:`shard_cache`); the logits come out whole on
every rank.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ..distributed import sharding as shd
from ..distributed import tp
from ..launch import mesh as mesh_lib
from ..models import api as _api
from ..models import attention as _attn
from ..models import moe as _moe
from ..optim import adamw
from ..optim.adamw import AdamWConfig


class TrainState(NamedTuple):
    params: Any
    opt: Dict[str, Any]


def resolve_mesh(mesh) -> mesh_lib.Mesh:
    """The mesh a step runs on: ``None`` is one device, an abstract (1, 1)
    mesh over (``data``, ``model``); a shape tuple becomes
    ``make_mesh(shape, SHAPE_AXES[:len(shape)])``, as the launcher's
    ``--mesh-shape`` does. An abstract mesh of more than one device (no
    ranks) raises ``ValueError``."""
    if mesh is None:
        mesh = mesh_lib.Mesh((1, 1), mesh_lib.SHAPE_AXES)
    elif not isinstance(mesh, mesh_lib.Mesh):
        shape = tuple(mesh)
        mesh = mesh_lib.make_mesh(shape, mesh_lib.SHAPE_AXES[:len(shape)])
    if mesh.abstract and mesh.size > 1:
        raise ValueError(f"a {tuple(mesh.shape.values())} mesh over {mesh.axis_names} has "
                         f"no ranks: it needs a torch.distributed world of {mesh.size} "
                         "(torchrun --nproc-per-node)")
    return mesh


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


def state_specs(model, mesh) -> TrainState:
    """The spec of every leaf of the train state on ``mesh`` (JAX's
    ``state_shardings``): params by ``param_specs``, ``m``, ``v`` and
    ``master`` by ``opt_specs``, ``step`` replicated."""
    params = abstract_train_state(model).params
    o = shd.opt_specs(params, mesh)
    return TrainState(shd.param_specs(params, mesh), {"m": o, "v": o, "master": o,
                                                      "step": shd.P()})


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a state tree and its spec tree."""
    if isinstance(tree, tuple):  # TrainState
        return type(tree)(*(_zip_map(fn, t, s) for t, s in zip(tree, specs)))
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, t, s) for t, s in zip(tree, specs)]
    return fn(tree, specs)


def shard_state(state: TrainState, specs: TrainState, mesh) -> TrainState:
    """This rank's blocks of a full train state."""
    return _zip_map(lambda t, s: shd.shard(t, s, mesh), state, specs)


def gather_state(state: TrainState, specs: TrainState, mesh) -> TrainState:
    """The full train state from every rank's blocks (a collective: every
    rank calls it)."""
    return _zip_map(lambda t, s: shd.gather(t, s, mesh), state, specs)


def _split(batch, k: int):
    """``batch`` cut into ``k`` microbatches along the batch axis."""
    for name, x in batch.items():
        if x.shape[0] % k:
            raise ValueError(f"batch[{name!r}]: {x.shape[0]} rows do not split into "
                             f"{k} microbatches")
    return [{name: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i]
             for name, x in batch.items()} for i in range(k)]


def _rows(model, mesh, batch):
    """This rank's rows of a global batch by ``batch_specs``' dim 0. A MoE
    model routes in token-major groups of ``GROUP_SIZE`` tokens: split rows
    give the whole batch's groups only when a rank holds a multiple of
    ``GROUP_SIZE`` tokens, so other splits raise ``ValueError``."""
    entries = {shd.batch_specs(batch, mesh)[k][0] for k in batch}
    if len(entries) != 1:
        raise ValueError(f"the batch's leaves split differently over the mesh: {entries}")
    entry = entries.pop()
    n = mesh_lib.axis_size(mesh, shd.entry_axes(entry))
    if n == 1:
        return batch
    rows, seq = batch["tokens"].shape[0] // n, batch["tokens"].shape[1]
    if model.cfg.n_experts and (rows * seq) % _moe.GROUP_SIZE:
        raise ValueError(f"a MoE model routes in groups of {_moe.GROUP_SIZE} tokens: "
                         f"{rows} rows x {seq} tokens a rank ({n} ranks over {entry}) split "
                         f"the groups; give each rank a multiple of {_moe.GROUP_SIZE} tokens")
    return {k: shd.shard(x, shd.P(entry), mesh) for k, x in batch.items()}


def make_train_step(model, mesh=None, opt_cfg: AdamWConfig = AdamWConfig()) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``, metrics ``loss``,
    ``xent``, ``aux``, ``grad_norm`` and ``lr`` (0-d tensors, the same on
    every rank). ``mesh``: see :func:`resolve_mesh`; ``state`` holds this
    rank's blocks (:func:`shard_state`; on one device the whole state) and
    ``batch`` is the global batch. ``REPRO_MICROBATCH=k`` (read here)
    accumulates the fp32 gradients of ``k`` microbatches of the rank's rows,
    as in JAX, where ``xent`` then holds the mean total loss. ``REPRO_SCORE_BF16=1`` (read at
    each step) computes the attention scores in bf16."""
    mesh = resolve_mesh(mesh)
    ctx = tp.context(mesh)
    microbatches = int(os.environ.get("REPRO_MICROBATCH", "0")) or 1

    def loss_and_grads(params, batch):
        flat = adamw.leaves(params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        if os.environ.get("REPRO_SCORE_BF16") == "1":
            _attn.set_block_config(score_dtype=torch.bfloat16)
        try:
            with torch.enable_grad():
                total, metrics = model.loss(batch, adamw.unflatten(params, leaves), ctx=ctx)
                # the loss is whole on every rank of a model group: its
                # gradient's shares are 1/m each
                grads = torch.autograd.grad(total, leaves,
                                            grad_outputs=torch.full_like(total, 1.0 / ctx.size),
                                            materialize_grads=True)
        finally:
            _attn.reset_block_config()
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)

    def value_and_grads(params, batch):
        if microbatches <= 1:
            return loss_and_grads(params, batch)
        k = microbatches
        acc, loss_sum, aux_sum = None, 0.0, 0.0
        for mb in _split(batch, k):
            loss_i, metrics_i, grads_i = loss_and_grads(params, mb)
            acc = ([g.float() for g in grads_i] if acc is None
                   else [a + g.float() for a, g in zip(acc, grads_i)])
            loss_sum = loss_sum + loss_i
            aux_sum = aux_sum + metrics_i["aux"]
        loss = loss_sum / k
        return loss, {"aux": aux_sum / k, "xent": loss}, [a / k for a in acc]

    specs = state_specs(model, mesh)
    p_specs, o_specs = adamw.leaves(specs.params), adamw.leaves(specs.opt["m"])
    dp = mesh_lib.dp_axis_names(mesh)
    # the opt-spec blocks of a param-spec block: its split over the data axes
    dp_specs = [shd.P(*(None if e == "model" else e for e in s)) for s in o_specs]
    whole = [not any("model" in shd.entry_axes(e) for e in s) for s in p_specs]

    def train_step(state: TrainState, batch):
        rows = _rows(model, mesh, _to_device(model, batch))
        loss, metrics, grads = value_and_grads(state.params, rows)
        grads = _sum_whole_leaves(grads, whole, ctx)
        names = sorted(metrics)
        reduced = shd.mean_over(grads + [loss] + [metrics[k] for k in names], mesh, dp)
        grads, loss = reduced[:len(grads)], reduced[len(grads)]
        metrics = dict(zip(names, reduced[len(grads) + 1:]))
        gnorm = _global_norm(grads, whole, ctx)
        blocks = [shd.shard(g, s, mesh) for g, s in zip(grads, dp_specs)]
        new_blocks, new_opt, opt_metrics = adamw.adamw_update(
            opt_cfg, adamw.unflatten(state.params, blocks), state.opt, state.params,
            gnorm=gnorm)
        new_params = adamw.unflatten(state.params, [
            shd.gather(t, s, mesh, axes=dp)
            for t, s in zip(adamw.leaves(new_blocks), o_specs)])
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return TrainState(new_params, new_opt), metrics

    return train_step


def _to_device(model, batch):
    return {k: torch.as_tensor(v).to(model.dev) for k, v in batch.items()}


def _sum_whole_leaves(grads, whole, ctx):
    """The gradients of the leaves stored whole summed over the model group
    (each rank holds a share), in one fp32 all-reduce; the others as they
    are."""
    idx = [i for i, w in enumerate(whole) if w]
    if not idx or ctx.size == 1:
        return grads
    flat = tp.all_reduce(torch.cat([grads[i].float().reshape(-1) for i in idx]), ctx)
    out, at = list(grads), 0
    for i in idx:
        n = grads[i].numel()
        out[i] = flat[at:at + n].reshape(grads[i].shape).to(grads[i].dtype)
        at += n
    return out


def _global_norm(grads, whole, ctx):
    """``adamw.global_norm`` of the whole gradient tree from this rank's
    blocks: each split leaf's sum of squares all-reduced over the model
    group, each whole leaf's (the same on every rank) counted once, added
    in JAX's leaf order (on one rank, ``adamw.global_norm``'s sum)."""
    sq = torch.stack([torch.sum(torch.square(g.float())) for g in grads])
    split = torch.tensor([not w for w in whole], device=sq.device)
    sq = torch.where(split, tp.all_reduce(torch.where(split, sq, 0.0), ctx), sq)
    return torch.sqrt(sum(sq.unbind()))


# ---------------------------------------------------------------------------
# Prefill and decode on a mesh
# ---------------------------------------------------------------------------


def shard_params(params, mesh):
    """This rank's ``param_specs`` blocks of a full params tree (JAX layout)."""
    return _zip_map(lambda t, s: shd.shard(t, s, mesh), params, shd.param_specs(params, mesh))


def shard_cache(cache, mesh):
    """This rank's ``cache_specs`` blocks of a full decode cache."""
    return _zip_map(lambda t, s: shd.shard(t, s, mesh), cache, shd.cache_specs(cache, mesh))


def gather_cache(blocks, specs, mesh):
    """The full decode cache from every rank's blocks (a collective);
    ``specs``: ``cache_specs`` of the full cache (:func:`cache_specs`)."""
    return _zip_map(lambda t, s: shd.gather(t, s, mesh), blocks, specs)


def cache_specs(model, mesh, batch: int, seq: int):
    """``sharding.cache_specs`` of ``model.make_cache(batch, seq)`` (JAX's
    ``cache_shardings``), from its shapes alone."""
    return shd.cache_specs(model._cache(batch, seq, torch.device("meta")), mesh)


def _gather_rows(x, entry, mesh):
    return x if entry is None else shd.gather(x, shd.P(entry), mesh)


def make_prefill_step(model, mesh=None) -> Callable:
    """``prefill(params, batch) -> logits (B, 1, V_padded)``, whole on every
    rank: ``params`` this rank's ``param_specs`` blocks (:func:`shard_params`),
    ``batch`` the global prompt batch, whose rows split over the data axes
    as in the train step; each model group runs ``Model.prefill`` on its
    blocks (its self-attention through K6, with the rank's query offset in
    the sequence-parallel layout)."""
    mesh = resolve_mesh(mesh)
    ctx = tp.context(mesh)

    def prefill(params, batch):
        batch = _to_device(model, batch)
        entry = shd.batch_specs(batch, mesh)["tokens"][0]
        logits = model.prefill(_rows(model, mesh, batch), params=params, ctx=ctx)
        return _gather_rows(logits, entry, mesh)

    return prefill


def moe_decode_refusal(cfg, mesh, batch: int) -> Optional[str]:
    """Why :func:`make_decode_step` refuses a decode of ``batch`` rows of a
    MoE model on ``mesh`` (each rank's rows split the routing group of
    ``min(128, batch)`` tokens: the routes and capacity would change), or
    None."""
    entry = shd._dp_entry(mesh, batch)
    n = mesh_lib.axis_size(mesh, shd.entry_axes(entry))
    group = min(_moe.GROUP_SIZE, batch)
    if cfg.n_experts and (batch // n) % group:
        return (f"a MoE model routes the {batch} decode tokens in groups of {group}: "
                f"{batch // n} rows a rank ({n} ranks over {entry}) regroup them")
    return None


def make_decode_step(model, mesh, batch: int, seq: int) -> Callable:
    """``decode(params, cache, tokens, position) -> (logits (B, 1, V_padded)
    whole on every rank, cache)`` for a cache of ``model.make_cache(batch,
    seq)``: ``params`` this rank's ``param_specs`` blocks, ``cache`` its
    ``cache_specs`` blocks (:func:`shard_cache`, updated in place), ``tokens``
    the global (B, 1). The KV slots split over ``model``: the rank that holds
    slot ``min(position, S - 1)`` writes it, each rank scores its slots and
    the softmax is merged over the group; the SSM state splits over its
    heads. A MoE model routes the whole batch's group: a split of the rows
    over the data axes that regroups the tokens raises ``ValueError``."""
    mesh = resolve_mesh(mesh)
    ctx = tp.context(mesh)
    lens = (model.dec_len(seq), seq) if model.cfg.is_encdec else (seq, 0)
    entry = shd._dp_entry(mesh, batch)
    refusal = moe_decode_refusal(model.cfg, mesh, batch)
    if refusal:
        raise ValueError(refusal)

    def decode(params, cache, tokens, position):
        tokens = torch.as_tensor(tokens).to(model.dev)
        rows = tokens if entry is None else shd.shard(tokens, shd.P(entry), mesh)
        logits, cache = model.decode_step(cache, rows, position, params=params, ctx=ctx,
                                          cache_lens=lens)
        return _gather_rows(logits, entry, mesh), cache

    return decode

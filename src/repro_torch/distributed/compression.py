"""Absmax int8 compression (port of ``repro.distributed.compression``).

A payload travels as int8 with one fp32 scale beside it; the receiver
multiplies back. The slab solve sends its halos so; the training side
averages gradients so across the pods' boundary:
``compressed_psum_pod`` all-gathers every leaf's int8 payload and scale
over the ``pod`` group, dequantises and averages. At pod=2 a rank sends its
N-byte int8 payload once, where an fp32 ring all-reduce of the same N
elements sends 2 (pod-1)/pod x 4N = 4N bytes: 4x fewer bytes on the wire.
``make_compressed_grad_fn``
is autograd's value and gradients with that mean across pods and the exact
mean over ``data`` inside a pod.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

from ..optim import adamw
from .sharding import P, mean_over, shard


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)`` with ``q = round(g / scale)`` clipped to [-127, 127]
    and ``scale = max(max|g| / 127, 1e-30)`` (a 0-dim fp32 tensor); rounding
    is half to even, as ``jnp.round``."""
    g32 = g.to(torch.float32)
    scale = torch.clamp(g32.abs().max() / 127.0, min=1e-30)
    q = torch.clamp(torch.round(g32 / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_pod(grads, group):
    """The mean of a gradient tree (nested dicts and lists of tensors) over
    the ranks of ``group``, each leaf sent as int8: quantised, its payload
    and scale all-gathered, dequantised as ``q.float() * scale``, averaged
    over the gathered axis and cast back to the leaf's dtype."""
    n = dist.get_world_size(group)

    def one(g):
        q, scale = quantize_int8(g)
        qs = [torch.empty_like(q) for _ in range(n)]
        ss = [torch.empty_like(scale.reshape(1)) for _ in range(n)]
        dist.all_gather(qs, q.contiguous(), group=group)
        dist.all_gather(ss, scale.reshape(1), group=group)
        deq = torch.stack(qs).to(torch.float32) * torch.cat(ss).reshape((n,) + (1,) * g.dim())
        return torch.mean(deq, dim=0).to(g.dtype)

    return adamw.unflatten(grads, [one(g) for g in adamw.leaves(grads)])


def _value_and_grad(loss_fn: Callable, params, batch):
    """``((loss, aux), grads)`` of ``loss_fn(params, batch) -> (loss, aux)``
    through autograd, on detached copies of the params' leaves."""
    leaves = [p.detach().requires_grad_(True) for p in adamw.leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(adamw.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    aux = adamw.unflatten(aux, [a.detach() for a in adamw.leaves(aux)])
    return (loss.detach(), aux), adamw.unflatten(params, list(grads))


def make_compressed_grad_fn(loss_fn: Callable, mesh) -> Callable:
    """``grad_fn(params, batch) -> ((loss, aux), grads)``: autograd's value
    and gradients of ``loss_fn(params, batch) -> (loss, aux)`` (aux a tree of
    tensors). Without a ``pod`` axis, on this rank's inputs as they are.
    With one (a mesh with ranks), ``batch`` (a dict of tensors) is the
    global batch: the rank takes its rows over (pod, data), major to minor;
    its gradients take the exact mean over the ``data`` group (what GSPMD
    does inside a pod), then :func:`compressed_psum_pod` over ``pod``; the
    loss and aux are averaged over both. Params are replicated."""
    if "pod" not in mesh.axis_names:
        return lambda params, batch: _value_and_grad(loss_fn, params, batch)
    rows_spec = P(("pod", "data") if "data" in mesh.axis_names else "pod")

    def grad_fn(params, batch):
        rows = {k: shard(x, rows_spec, mesh) for k, x in batch.items()}
        (loss, aux), grads = _value_and_grad(loss_fn, params, rows)
        g = mean_over(adamw.leaves(grads), mesh, ["data"])
        grads = compressed_psum_pod(adamw.unflatten(grads, g), mesh.group("pod"))
        scalars = mean_over([loss] + adamw.leaves(aux), mesh, ["data", "pod"])
        return (scalars[0], adamw.unflatten(aux, scalars[1:])), grads

    return grad_fn

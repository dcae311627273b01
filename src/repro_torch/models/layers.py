"""Shared neural-net building blocks (functional, dict params).

Port of ``repro.models.layers``. Conventions, as in the JAX package:
  * params are nested dicts of tensors; ``make_*`` functions take a
    ``torch.Generator`` (or None for uninitialised storage) and return the
    dict; dense weights are ``(d_in, d_out)``, used as ``x @ w``;
  * activations run in ``compute_dtype`` (bf16 by default), parameters are
    stored in ``param_dtype``; reductions (norms, softmax) in fp32.

Random draws are made in fp32 on the generator's device (the CPU unless the
caller says otherwise), scaled, cast and moved to ``device``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def remat(fn, *args):
    """``fn(*args)``; where autograd records, recomputed in backward instead
    of keeping its intermediates (JAX's ``jax.checkpoint``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _normal(gen: Optional[torch.Generator], shape, dtype, scale: float,
            device) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (scale * x).to(device=device, dtype=dtype)


def make_dense(gen, d_in: int, d_out: int, dtype, device, bias: bool = False,
               scale: Optional[float] = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal(gen, (d_in, d_out), dtype, scale, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p: Params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    y = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def make_norm(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def make_layernorm(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float, compute_dtype) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(compute_dtype)


def layernorm(p: Params, x: torch.Tensor, eps: float, compute_dtype) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(compute_dtype)


def norm_apply(p: Params, x, eps, compute_dtype):
    if "bias" in p:
        return layernorm(p, x, eps, compute_dtype)
    return rmsnorm(p, x, eps, compute_dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (rotate-half: the two halves of the head)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions: broadcastable to (..., S). Angles
    in fp32; the result in x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (hd/2,)
    angles = positions[..., None].float() * freqs                # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def make_mlp(gen, d_model: int, d_ff: int, dtype, device, act: str = "silu") -> Params:
    if act == "silu":  # SwiGLU: gate, up, down
        return {
            "gate": make_dense(gen, d_model, d_ff, dtype, device),
            "up": make_dense(gen, d_model, d_ff, dtype, device),
            "down": make_dense(gen, d_ff, d_model, dtype, device),
        }
    return {  # plain 2-matrix MLP (whisper)
        "up": make_dense(gen, d_model, d_ff, dtype, device, bias=True),
        "down": make_dense(gen, d_ff, d_model, dtype, device, bias=True),
    }


def mlp(p: Params, x: torch.Tensor, act: str, compute_dtype) -> torch.Tensor:
    if act == "silu":
        g = dense(p["gate"], x, compute_dtype)
        u = dense(p["up"], x, compute_dtype)
        return dense(p["down"], F.silu(g) * u, compute_dtype)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(dense(p["up"], x, compute_dtype), approximate="tanh")
    return dense(p["down"], h, compute_dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def make_embedding(gen, vocab: int, d_model: int, dtype, device) -> Params:
    return {"table": _normal(gen, (vocab, d_model), dtype, 0.02, device)}


def embed(p: Params, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    # the cast commutes with the gather: only the gathered rows are cast
    return p["table"][tokens].to(compute_dtype)


def unembed(table: torch.Tensor, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return x.to(compute_dtype) @ table.to(compute_dtype).t()


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 vocab_real: int) -> torch.Tensor:
    """Mean cross entropy in fp32; the padded vocab tail gets -1e9 added."""
    logits = logits.float()
    if vocab_real < logits.shape[-1]:
        mask = torch.zeros((logits.shape[-1],), dtype=torch.float32, device=logits.device)
        mask[vocab_real:] = -1e9
        logits = logits + mask
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets.long()[..., None], dim=-1)[..., 0]
    return torch.mean(logz - gold)

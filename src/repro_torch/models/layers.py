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
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed import tp

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


def mlp(p: Params, x: torch.Tensor, act: str, compute_dtype, d_ff: Optional[int] = None,
        lay=None) -> torch.Tensor:
    """The MLP of ``x`` in the residual layout ``lay`` (one rank's by
    default): a Megatron pair (:func:`mlp_partial`) over the whole sequence
    when ``d_ff`` (the weights' own width by default) splits over the
    group, else the whole weights on the residual's rows."""
    lay = lay or tp.layout(tp.ONE, x.shape[1])
    ctx, d = lay.ctx, x.shape[-1]
    d_ff = d_ff or p["up"]["w"].shape[1]
    lo, hi = tp.span(ctx, d_ff)
    if hi - lo < d_ff:
        y = tp.from_partial(mlp_partial(p, tp.to_whole(x, lay), act, d, d_ff, lo, hi,
                                        compute_dtype, ctx), lay)
    else:
        y = mlp_partial(p, x, act, d, d_ff, 0, d_ff, compute_dtype, ctx)
    return add_bias(p["down"], y, d, compute_dtype, ctx)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def make_embedding(gen, vocab: int, d_model: int, dtype, device) -> Params:
    return {"table": _normal(gen, (vocab, d_model), dtype, 0.02, device)}


def embed(p: Params, tokens: torch.Tensor, compute_dtype, vocab: Optional[int] = None,
          ctx=tp.ONE) -> torch.Tensor:
    """The rows of ``tokens``. A table stored as this rank's rows of a
    ``vocab``-row table is vocab-parallel: each rank looks up the tokens its
    rows hold, zeros elsewhere, and an all-reduce adds them (exact: one rank
    contributes)."""
    table = p["table"]
    n = table.shape[0]
    if n == (vocab or n):
        # the cast commutes with the gather: only the gathered rows are cast
        return table[tokens].to(compute_dtype)
    if n * ctx.size != vocab:
        raise ValueError(f"a table of {n} rows is no block of {vocab} over {ctx.size} ranks")
    idx = tokens - ctx.rank * n
    own = (idx >= 0) & (idx < n)
    e = table[idx.clamp(0, n - 1)].to(compute_dtype)
    return tp.reduce(torch.where(own[..., None], e, torch.zeros((), dtype=e.dtype,
                                                                 device=e.device)), ctx)


def unembed(table: torch.Tensor, x: torch.Tensor, compute_dtype, vocab: Optional[int] = None,
            ctx=tp.ONE) -> torch.Tensor:
    """The logits of ``x`` over this rank's columns ``tp.span(ctx, vocab)``
    of the ``vocab``-row table (all of them when the vocabulary does not
    split)."""
    vocab = vocab or table.shape[0]
    lo, hi = tp.span(ctx, vocab)
    w = tp.take(table, (vocab, x.shape[-1]), ctx, 0, lo, hi)
    return x.to(compute_dtype) @ w.to(compute_dtype).t()


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


# ---------------------------------------------------------------------------
# Over a model group (``repro_torch.distributed.tp``): each function takes
# the rank's stored blocks of the weights and uses a block as it is where the
# compute needs exactly it, else gathers the weight
# ---------------------------------------------------------------------------


def norm_whole(p: Params, d: int, ctx) -> Params:
    """A norm's params whole (a stacked norm's scale is stored split)."""
    return {k: tp.whole(v, (d,), ctx) for k, v in p.items()}


def dense_cols(p: Params, x, d_in: int, d_out: int, lo: int, hi: int, compute_dtype,
               ctx) -> torch.Tensor:
    """Columns ``[lo, hi)`` of ``dense(p, x)`` for a ``(d_in, d_out)``
    weight, bias included."""
    y = x.to(compute_dtype) @ tp.take(p["w"], (d_in, d_out), ctx, -1, lo, hi).to(compute_dtype)
    if "b" in p:
        y = y + tp.take(p["b"], (d_out,), ctx, 0, lo, hi).to(compute_dtype)
    return y


def dense_rows(p: Params, x, d_in: int, d_out: int, lo: int, hi: int, compute_dtype,
               ctx) -> torch.Tensor:
    """``x`` (input columns ``[lo, hi)``) times the weight's rows ``[lo,
    hi)``: this rank's summand of ``dense``, without the bias."""
    return x.to(compute_dtype) @ tp.take(p["w"], (d_in, d_out), ctx, 0, lo, hi).to(compute_dtype)


def add_bias(p: Params, y, d_out: int, compute_dtype, ctx) -> torch.Tensor:
    if "b" in p:
        y = y + tp.whole(p["b"], (d_out,), ctx).to(compute_dtype)
    return y


def as_partial(y: torch.Tensor, ctx) -> torch.Tensor:
    """A whole tensor as a summand: itself on rank 0, zeros elsewhere."""
    return y if ctx.rank == 0 else torch.zeros_like(y)


def mlp_partial(p: Params, x, act: str, d: int, d_ff: int, lo: int, hi: int,
                compute_dtype, ctx) -> torch.Tensor:
    """The Megatron pair on hidden units ``[lo, hi)``: column-parallel
    gate / up, row-parallel down; this rank's summand, without down's bias."""
    if act == "silu":
        g = dense_cols(p["gate"], x, d, d_ff, lo, hi, compute_dtype, ctx)
        u = dense_cols(p["up"], x, d, d_ff, lo, hi, compute_dtype, ctx)
        h = F.silu(g) * u
    else:
        h = F.gelu(dense_cols(p["up"], x, d, d_ff, lo, hi, compute_dtype, ctx),
                   approximate="tanh")
    return dense_rows(p["down"], h, d_ff, d, lo, hi, compute_dtype, ctx)


def softmax_xent_tp(logits: torch.Tensor, lo: int, targets: torch.Tensor, vocab_real: int,
                    ctx) -> torch.Tensor:
    """Vocab-parallel :func:`softmax_xent` of this rank's logits columns
    ``[lo, lo + n)``: the row max and the sum of exp all-reduced over the
    group, the target's logit from the rank that holds its column, the
    padded tail masked by its global column index."""
    n = logits.shape[-1]
    lf = logits.float()
    col = lo + torch.arange(n, device=lf.device)
    if vocab_real < lo + n:
        lf = lf + torch.where(col >= vocab_real, -1e9, 0.0).to(lf.dtype)
    mx = tp.all_reduce(lf.detach().amax(dim=-1), ctx, dist.ReduceOp.MAX)
    se = tp.reduce(torch.exp(lf - mx[..., None]).sum(dim=-1), ctx)
    t = targets.long() - lo
    own = (t >= 0) & (t < n)
    gold = torch.take_along_dim(lf, t.clamp(0, n - 1)[..., None], dim=-1)[..., 0]
    gold = tp.reduce(torch.where(own, gold, torch.zeros((), device=lf.device)), ctx)
    return torch.mean(torch.log(se) + mx - gold)

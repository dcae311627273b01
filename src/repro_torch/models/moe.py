"""Mixture-of-Experts block: GShard-style capacity dispatch.

Port of ``repro.models.moe``. Routing: softmax over all experts, top-k,
renormalised (OLMoE-style). Tokens are grouped (static group size) and
routed into per-expert capacity slots through one-hot dispatch and combine
einsums built in the compute dtype; the (token, choice) pairs take their
capacity slots in token-major order, so the same pairs are dropped as in
JAX. Shared experts (DeepSeekMoE) are one wide SwiGLU.

The block is split into :func:`route`, :func:`dispatch`, :func:`experts` and
:func:`combine`, each looked up in this module when ``moe_block`` runs: the
parity tests hold the routing against JAX's, and a profiler can wrap each
stage.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..distributed import sharding as shd
from ..distributed import tp
from . import layers as L

Params = Dict[str, Any]

GROUP_SIZE = 128
CAPACITY_FACTOR = 1.25


class Routing(NamedTuple):
    """One MoE layer's routing of its (n_groups, group) tokens."""

    probs: torch.Tensor    # (g, s, e) fp32 router softmax
    top_p: torch.Tensor    # (g, s, k) fp32, renormalised over the k choices
    top_idx: torch.Tensor  # (g, s, k) int64 experts, descending p, lower index first on ties
    onehot: torch.Tensor   # (g, s, k, e) fp32 one-hot of top_idx
    pos: torch.Tensor      # (g, s, k) fp32 slot of each choice in its expert's buffer
    keep: torch.Tensor     # (g, s, k) bool, the slot is inside the capacity


def make_moe(gen, cfg, dtype, device) -> Params:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    scale = 1.0 / math.sqrt(d)
    p = {
        "router": L.make_dense(gen, d, e, dtype, device),
        "gate": L._normal(gen, (e, d, f), dtype, scale, device),
        "up": L._normal(gen, (e, d, f), dtype, scale, device),
        "down": L._normal(gen, (e, f, d), dtype, 1.0 / math.sqrt(f), device),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.make_mlp(gen, d, cfg.n_shared_experts * cfg.moe_d_ff, dtype,
                                 device, act="silu")
    return p


def _capacity(group: int, top_k: int, n_experts: int) -> int:
    c = int(math.ceil(group * top_k * CAPACITY_FACTOR / n_experts))
    return max(4 * ((c + 3) // 4), 4)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(p: Params, cfg, xg: torch.Tensor, compute_dtype) -> Routing:
    """xg: (g, s, d) -> the top-k routing and capacity slots."""
    e, k = cfg.n_experts, cfg.top_k
    n_groups, group, _ = xg.shape
    logits = L.dense(p["router"], xg, compute_dtype).float()
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k puts the lower index first on a tie; a stable descending
    # sort does too (torch.topk promises no order on ties)
    top_p, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_idx = top_p[..., :k], top_idx[..., :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    onehot = _one_hot(top_idx, e, torch.float32)                  # (g, s, k, e)
    # slot of each (token, choice) in its expert's buffer, token-major
    pos = torch.cumsum(onehot.reshape(n_groups, group * k, e), dim=1) - 1.0
    pos_in_e = (pos.reshape(n_groups, group, k, e) * onehot).sum(dim=-1)
    return Routing(probs, top_p, top_idx, onehot, pos_in_e,
                   pos_in_e < _capacity(group, k, e))


def aux_loss(r: Routing, n_experts: int) -> torch.Tensor:
    """Switch load-balance loss: e * mean_e(frac_tokens_e * mean_prob_e)."""
    frac = r.onehot.sum(dim=2).mean(dim=1)                        # (g, e)
    return n_experts * torch.mean(frac * r.probs.mean(dim=1))


def dispatch(r: Routing, xg: torch.Tensor, compute_dtype, experts_range=None):
    """(expert inputs (e, g, c, d), combine tensor (g, s, e, c)), the one-hot
    tensors built in the compute dtype (exact for 0/1); only experts
    ``[lo, hi)`` when ``experts_range`` gives them."""
    _, group, k, e = r.onehot.shape
    cap = _capacity(group, k, e)
    onehot = r.onehot.to(compute_dtype)
    top_p = (r.top_p * r.keep).to(compute_dtype)[..., None]
    if experts_range is not None:
        onehot = onehot[..., experts_range[0]:experts_range[1]]
    cap_oh = _one_hot(r.pos.long(), cap, compute_dtype)           # (g, s, k, c)
    keep_c = r.keep.to(compute_dtype)
    disp = torch.einsum("gske,gskc->gsec", onehot, cap_oh * keep_c[..., None])
    comb = torch.einsum("gske,gskc->gsec", top_p * onehot, cap_oh)
    xin = torch.einsum("gsec,gsd->egcd", disp, xg.to(compute_dtype))
    return xin, comb


def experts(p: Params, xin: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Every expert's SwiGLU on its capacity slots: (e, g, c, d) -> (e, g, c, d)."""
    g_act = torch.einsum("egcd,edf->egcf", xin, p["gate"].to(compute_dtype))
    u_act = torch.einsum("egcd,edf->egcf", xin, p["up"].to(compute_dtype))
    return torch.einsum("egcf,efd->egcd", F.silu(g_act) * u_act,
                        p["down"].to(compute_dtype))


def combine(comb: torch.Tensor, y_e: torch.Tensor) -> torch.Tensor:
    """Each token's kept choices, weighted: (g, s, e, c) x (e, g, c, d) -> (g, s, d)."""
    return torch.einsum("gsec,egcd->gsd", comb, y_e)


def moe_block(p: Params, cfg, h: torch.Tensor, compute_dtype, lay=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h: (B, S, D) in the residual layout ``lay`` (one rank's by default)
    -> (out, aux_loss), with ``sharding.expert_constraint``'s layout. B*S
    must be a multiple of min(GROUP_SIZE, B*S), as in JAX. Routing, capacity
    and the aux loss run on the whole sequence on every rank of a model
    group (the 128-token groups are token-major over B*S: routing a block of
    rows would regroup the tokens and move the drops); each rank dispatches
    to its experts and runs them (its stored blocks), its share of the
    combine and the shared experts' Megatron pair are summands, and one
    reduction completes them."""
    lay = lay or tp.layout(tp.ONE, h.shape[1])
    ctx, cd = lay.ctx, compute_dtype
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    x = tp.to_whole(h, lay)
    b, s, _ = x.shape
    tokens = b * s
    group = min(GROUP_SIZE, tokens)
    if tokens % group:
        raise ValueError(f"moe_block groups {tokens} tokens by {group}: B*S must be a "
                         f"multiple of {group}")
    xg = x.reshape(tokens // group, group, d)
    r = route({"router": {"w": tp.whole(p["router"]["w"], (d, e), ctx)}}, cfg, xg, cd)
    cap = _capacity(group, cfg.top_k, e)
    split_e = shd.expert_constraint(ctx.mesh)((e, tokens // group, cap, d))[0] == "model"
    lo, hi = tp.span(ctx, e) if split_e else (0, e)
    xin, comb = dispatch(r, xg, cd, (lo, hi))
    w = {n: tp.take(p[n], (e, d, f) if n != "down" else (e, f, d), ctx, 0, lo, hi)
         for n in ("gate", "up", "down")}
    out = combine(comb, experts(w, xin, cd))
    if hi - lo == e:
        out = L.as_partial(out, ctx)
    if "shared" in p:
        fs = cfg.n_shared_experts * f
        s_lo, s_hi = tp.span(ctx, fs)
        sh = L.mlp_partial(p["shared"], xg, "silu", d, fs, s_lo, s_hi, cd, ctx)
        out = out + (sh if s_hi - s_lo < fs else L.as_partial(sh, ctx))
    return tp.from_partial(out.reshape(b, s, d), lay), aux_loss(r, e).float()

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


def dispatch(r: Routing, xg: torch.Tensor, compute_dtype):
    """(expert inputs (e, g, c, d), combine tensor (g, s, e, c)), the one-hot
    tensors built in the compute dtype (exact for 0/1)."""
    _, group, k, e = r.onehot.shape
    cap = _capacity(group, k, e)
    onehot = r.onehot.to(compute_dtype)
    cap_oh = _one_hot(r.pos.long(), cap, compute_dtype)           # (g, s, k, c)
    keep_c = r.keep.to(compute_dtype)
    disp = torch.einsum("gske,gskc->gsec", onehot, cap_oh * keep_c[..., None])
    comb = torch.einsum("gske,gskc->gsec",
                        (r.top_p * r.keep).to(compute_dtype)[..., None] * onehot, cap_oh)
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


def moe_block(p: Params, cfg, x: torch.Tensor, compute_dtype
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss). B*S must be a multiple of
    min(GROUP_SIZE, B*S), as in JAX."""
    b, s, d = x.shape
    tokens = b * s
    group = min(GROUP_SIZE, tokens)
    if tokens % group:
        raise ValueError(f"moe_block groups {tokens} tokens by {group}: B*S must be a "
                         f"multiple of {group}")
    xg = x.reshape(tokens // group, group, d)
    r = route(p, cfg, xg, compute_dtype)
    xin, comb = dispatch(r, xg, compute_dtype)
    out = combine(comb, experts(p, xin, compute_dtype))
    if "shared" in p:
        out = out + L.mlp(p["shared"], xg, "silu", compute_dtype)
    return out.reshape(b, s, d), aux_loss(r, cfg.n_experts).float()

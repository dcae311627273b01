"""Mamba2 (SSD, state-space duality) block: the chunked prefill scan and
the O(1) recurrent decode step.

Port of ``repro.models.ssm``. Per head h a scalar decay A_h < 0; the input
is projected to z (gate), x (B,S,di), B, C (B,S,N) and dt (B,S,H); a causal
depthwise conv precedes the SSM. The sequence is cut into chunks of
``cfg.ssm_chunk`` (the whole sequence when that does not divide it): within
a chunk an attention-like (L x L lower-triangular decay) product, across
chunks a state recurrence, here a Python loop over the chunks (JAX's
``lax.scan``). Where autograd records, each chunk step is recomputed in
backward, as JAX's ``jax.checkpoint`` of it: only the (b, h, p, n) state
carries are kept, not the (b, h, L, L) decay blocks. The scan runs in fp32; ``A_log``,
``D`` and ``dt_bias`` are fp32 parameters whatever the model's dtype.

Decode keeps {"conv": (B, d_conv, di + 2N), "state": (B, H, P, N)} per
layer, both fp32.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from . import layers as L

Params = Dict[str, Any]


def make_ssm(gen, cfg, dtype, device) -> Params:
    d, di, n, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_n_heads
    conv_w = di + 2 * n
    f32 = torch.float32
    return {
        "in_proj": L.make_dense(gen, d, 2 * di + 2 * n + nh, dtype, device),
        "conv_w": L._normal(gen, (cfg.ssm_d_conv, conv_w), dtype, 0.5, device),
        "conv_b": torch.zeros((conv_w,), dtype=dtype, device=device),
        "A_log": torch.zeros((nh,), dtype=f32, device=device),
        "D": torch.ones((nh,), dtype=f32, device=device),
        "dt_bias": torch.zeros((nh,), dtype=f32, device=device),
        "norm": L.make_norm(di, dtype, device),
        "out_proj": L.make_dense(gen, di, d, dtype, device),
    }


def _split_proj(cfg, zxbcdt):
    di, n = cfg.ssm_d_inner, cfg.ssm_d_state
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n:]


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), without F.softplus' threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(xbc, w, b, compute_dtype):
    """Depthwise causal conv, width K: y_t = sum_k w_k x_{t-K+1+k}, summed in
    the compute dtype in JAX's order (0 + t0 + t1 + ...)."""
    kk, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, kk - 1, 0))
    y = pad[:, 0:s] * w[0][None, None, :]
    for i in range(1, kk):
        y = y + pad[:, i:i + s] * w[i][None, None, :]
    return F.silu(y + b[None, None, :]).to(compute_dtype)


def _segsum(a):
    """Lower-triangular segment sums: out[..., i, j] = sum_{j<m<=i} a[..., m],
    -inf above the diagonal."""
    ll = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((ll, ll), dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def _chunk_step(state, x_k, b_k, c_k, a_k):
    """One chunk: x_k (b,L,h,p), b_k / c_k (b,L,n), a_k (b,h,L), all fp32,
    and the incoming state (b,h,p,n) -> (new state, y (b,L,h,p) fp32)."""
    a_cum = torch.cumsum(a_k, dim=-1)
    # intra-chunk (diagonal block)
    ldec = torch.exp(_segsum(a_k))                                # (b,h,L,L)
    cb = c_k @ b_k.transpose(1, 2)                                # (b,L,L)
    y_diag = torch.einsum("bhlm,bmhp->blhp", cb[:, None] * ldec, x_k)
    # contribution of the incoming state
    y_off = torch.einsum("bln,bhpn,bhl->blhp", c_k, state, torch.exp(a_cum))
    # state update
    decay_in = torch.exp(a_cum[..., -1:] - a_cum)                 # (b,h,L)
    new_state = state * torch.exp(a_cum[..., -1])[..., None, None] + torch.einsum(
        "bln,bhl,blhp->bhpn", b_k, decay_in, x_k)
    return new_state, y_diag + y_off


def ssm_block(p: Params, cfg, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Prefill and training path. x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    di, n, nh, ph = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_n_heads, cfg.ssm_head_dim
    chunk = min(cfg.ssm_chunk, s)
    if s % chunk:
        chunk = s

    z, xbc, dt = _split_proj(cfg, L.dense(p["in_proj"], x, compute_dtype))
    xbc = _causal_conv(xbc, p["conv_w"].to(compute_dtype), p["conv_b"].to(compute_dtype),
                       compute_dtype)
    xs, bmat, cmat = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    xs = xs.reshape(b, s, nh, ph)

    dt = _softplus(dt.float() + p["dt_bias"])                     # (b,s,h)
    a_eff = -torch.exp(p["A_log"])[None, None, :] * dt            # (b,s,h) <= 0
    x_eff = (xs.float() * dt[..., None]).to(compute_dtype)

    state = torch.zeros((b, nh, ph, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        state, y = L.remat(_chunk_step, state, x_eff[:, c0:c0 + chunk].float(),
                           bmat[:, c0:c0 + chunk].float(), cmat[:, c0:c0 + chunk].float(),
                           a_eff[:, c0:c0 + chunk].transpose(1, 2))
        ys.append(y.to(compute_dtype))
    y = torch.cat(ys, dim=1)
    y = y + p["D"][None, None, :, None].to(compute_dtype) * xs
    y = y.reshape(b, s, di)
    # gated RMSNorm + output projection
    y = L.rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps, compute_dtype)
    return L.dense(p["out_proj"], y, compute_dtype)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def make_ssm_cache(cfg, batch: int, device, dtype=torch.float32):
    conv_w = cfg.ssm_d_inner + 2 * cfg.ssm_d_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_d_conv, conv_w), dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_d_state),
                             dtype=dtype, device=device),
    }


def ssm_decode_step(p: Params, cfg, x: torch.Tensor, cache, compute_dtype):
    """x: (B, 1, D) -> (out (B,1,D), new cache); O(1) in sequence length. The
    conv taps are summed in fp32, as in JAX."""
    b = x.shape[0]
    di, n, nh, ph = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_n_heads, cfg.ssm_head_dim
    z, xbc, dt = _split_proj(cfg, L.dense(p["in_proj"], x, compute_dtype))

    conv_buf = torch.cat([cache["conv"][:, 1:, :], xbc.to(cache["conv"].dtype)], dim=1)
    w = p["conv_w"].float()
    y = torch.sum(conv_buf.float() * w[None], dim=1, keepdim=True)
    xbc_t = F.silu(y + p["conv_b"].float()).to(compute_dtype)

    xbc_t = xbc_t[:, 0]
    xs, b_t, c_t = xbc_t[..., :di], xbc_t[..., di:di + n], xbc_t[..., di + n:]
    xs = xs.reshape(b, nh, ph)
    dt = _softplus(dt[:, 0].float() + p["dt_bias"])               # (b,h)
    da = torch.exp(-torch.exp(p["A_log"])[None] * dt)             # (b,h)
    x_eff = xs.float() * dt[..., None]

    state = cache["state"] * da[..., None, None] + torch.einsum(
        "bn,bhp->bhpn", b_t.float(), x_eff)
    y = torch.einsum("bn,bhpn->bhp", c_t.float(), state)
    y = y + p["D"][None, :, None] * xs.float()
    y = y.reshape(b, 1, di).to(compute_dtype)
    y = L.rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps, compute_dtype)
    return L.dense(p["out_proj"], y, compute_dtype), {"conv": conv_buf, "state": state}

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

from ..distributed import sharding as shd
from ..distributed import tp
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


def _ssd(xs, bmat, cmat, dt, a_log, d_skip, dt_bias, chunk: int, compute_dtype):
    """The chunked SSD scan of heads ``xs`` (b, s, h, p) with B / C (b, s, n),
    raw dt (b, s, h) and the heads' ``A_log``, ``D`` and ``dt_bias`` ->
    y (b, s, h, p) in the compute dtype, D's skip included."""
    b, s, nh, ph = xs.shape
    n = bmat.shape[-1]
    dt = _softplus(dt.float() + dt_bias)                          # (b,s,h)
    a_eff = -torch.exp(a_log)[None, None, :] * dt                 # (b,s,h) <= 0
    x_eff = (xs.float() * dt[..., None]).to(compute_dtype)

    state = torch.zeros((b, nh, ph, n), dtype=torch.float32, device=xs.device)
    ys = []
    for c0 in range(0, s, chunk):
        state, y = L.remat(_chunk_step, state, x_eff[:, c0:c0 + chunk].float(),
                           bmat[:, c0:c0 + chunk].float(), cmat[:, c0:c0 + chunk].float(),
                           a_eff[:, c0:c0 + chunk].transpose(1, 2))
        ys.append(y.to(compute_dtype))
    y = torch.cat(ys, dim=1)
    return y + d_skip[None, None, :, None].to(compute_dtype) * xs


def _chunk_len(cfg, s: int) -> int:
    chunk = min(cfg.ssm_chunk, s)
    return s if s % chunk else chunk


def _heads(cfg, ctx, width: int):
    """This rank's SSM heads ``[lo, hi)``: split when
    ``sharding.ssm_inner_constraint`` splits the projection and the heads
    divide, else all of them."""
    nh = cfg.ssm_n_heads
    if shd.ssm_inner_constraint(ctx.mesh)((1, 1, width))[-1] != "model":
        return 0, nh
    return tp.span(ctx, nh)


def _gated_norm(p, y, z, cfg, di: int, lo: int, hi: int, compute_dtype, ctx):
    """The gated RMSNorm of the columns ``[lo, hi)`` of the inner width: its
    mean of squares over the whole width (the rank's sum all-reduced when
    the columns split)."""
    g = (y * F.silu(z)).float()
    if hi - lo < di:
        var = tp.reduce(torch.sum(g * g, dim=-1, keepdim=True), ctx) / di
    else:
        var = torch.mean(g * g, dim=-1, keepdim=True)
    scale = tp.take(p["scale"], (di,), ctx, 0, lo, hi)
    return (g * torch.rsqrt(var + cfg.norm_eps) * scale.float()).to(compute_dtype)


def ssm_block(p: Params, cfg, h: torch.Tensor, compute_dtype, lay=None) -> torch.Tensor:
    """Prefill and training path. h: (B, S, D) in the residual layout
    ``lay`` (one rank's by default) -> the same layout, in
    ``sharding.ssm_inner_constraint``'s: the sequence stays whole (the
    chunk scan runs along it); on a model group a rank takes its SSM heads
    (their x, z and dt columns of the gathered in_proj, their conv
    channels, with B and C whole), normalises with the mean of squares
    all-reduced, and its out_proj row block gives a summand."""
    lay = lay or tp.layout(tp.ONE, h.shape[1])
    ctx, cd = lay.ctx, compute_dtype
    d, di, n, nh, ph = (cfg.d_model, cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_n_heads,
                        cfg.ssm_head_dim)
    width, cw = 2 * di + 2 * n + nh, di + 2 * n
    x = tp.to_whole(h, lay)
    b, s, _ = x.shape
    lo, hi = _heads(cfg, ctx, width)
    nl = hi - lo
    dev = x.device
    xc = torch.arange(lo * ph, hi * ph, device=dev)
    bc = torch.arange(2 * n, device=dev)
    w_in = tp.whole(p["in_proj"]["w"], (d, width), ctx)
    conv_w = tp.whole(p["conv_w"], (cfg.ssm_d_conv, cw), ctx)
    conv_b = tp.whole(p["conv_b"], (cw,), ctx)
    if nl < nh:  # the rank's heads' columns and channels
        dtc = 2 * di + 2 * n + torch.arange(lo, hi, device=dev)
        w_in = w_in.index_select(1, torch.cat([xc, di + xc, 2 * di + bc, dtc]))
        ch = torch.cat([xc, di + bc])
        conv_w, conv_b = conv_w.index_select(1, ch), conv_b.index_select(0, ch)
    zxbcdt = x.to(cd) @ w_in.to(cd)
    z, xbc, dt = zxbcdt[..., :nl * ph], zxbcdt[..., nl * ph:2 * nl * ph + 2 * n], \
        zxbcdt[..., 2 * nl * ph + 2 * n:]
    xbc = _causal_conv(xbc, conv_w.to(cd), conv_b.to(cd), cd)
    xs = xbc[..., :nl * ph].reshape(b, s, nl, ph)
    bmat, cmat = xbc[..., nl * ph:nl * ph + n], xbc[..., nl * ph + n:]
    y = _ssd(xs, bmat, cmat, dt, tp.take(p["A_log"], (nh,), ctx, 0, lo, hi),
             tp.take(p["D"], (nh,), ctx, 0, lo, hi), tp.take(p["dt_bias"], (nh,), ctx, 0, lo, hi),
             _chunk_len(cfg, s), cd)
    y = _gated_norm(p["norm"], y.reshape(b, s, nl * ph), z, cfg, di, lo * ph, hi * ph, cd, ctx)
    out = L.dense_rows(p["out_proj"], y, di, d, lo * ph, hi * ph, cd, ctx)
    return tp.from_partial(out, lay) if nl < nh else tp.from_whole(out, lay)


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


def ssm_decode_step(p: Params, cfg, x: torch.Tensor, cache, compute_dtype, ctx=tp.ONE):
    """x: (B, 1, D) -> (out (B,1,D), new cache); O(1) in sequence length. The
    conv taps are summed in fp32, as in JAX. On a model group the cache is
    this rank's blocks (``sharding.cache_specs``): the state (B, H, P, N)
    split over the heads, the conv buffer (B, K, W) over its channels. The
    projection comes from in_proj's column blocks, all-gathered; the conv
    buffer's blocks do not align with the heads, so it is gathered,
    shifted, and the rank keeps its block; the rank's heads run the
    recurrence, the gated norm's mean of squares is all-reduced and
    out_proj's row block gives a summand that an all-reduce completes."""
    cd = compute_dtype
    b = x.shape[0]
    d, di, n, nh, ph = (cfg.d_model, cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_n_heads,
                        cfg.ssm_head_dim)
    width, cw = 2 * di + 2 * n + nh, di + 2 * n
    c_lo, c_hi = tp.span(ctx, width)
    y = L.dense_cols(p["in_proj"], x, d, width, c_lo, c_hi, cd, ctx)
    z, xbc, dt = _split_proj(cfg, tp.all_gather(y, -1, ctx) if c_hi - c_lo < width else y)

    conv = cache["conv"]
    w_lo, w_hi = tp.span(ctx, cw)
    conv_full = tp.all_gather(conv, 2, ctx) if w_hi - w_lo < cw else conv
    conv_buf = torch.cat([conv_full[:, 1:, :], xbc.to(conv.dtype)], dim=1)
    w = tp.whole(p["conv_w"], (cfg.ssm_d_conv, cw), ctx).float()
    yc = torch.sum(conv_buf.float() * w[None], dim=1, keepdim=True)
    xbc_t = F.silu(yc + tp.whole(p["conv_b"], (cw,), ctx).float()).to(cd)[:, 0]

    lo, hi = tp.span(ctx, nh)
    nl = hi - lo
    xs = xbc_t[..., lo * ph:hi * ph].reshape(b, nl, ph)
    b_t, c_t = xbc_t[..., di:di + n], xbc_t[..., di + n:]
    dt = _softplus(dt[:, 0, lo:hi].float() + tp.take(p["dt_bias"], (nh,), ctx, 0, lo, hi))
    da = torch.exp(-torch.exp(tp.take(p["A_log"], (nh,), ctx, 0, lo, hi))[None] * dt)
    x_eff = xs.float() * dt[..., None]
    state = cache["state"] * da[..., None, None] + torch.einsum(
        "bn,bhp->bhpn", b_t.float(), x_eff)
    yh = torch.einsum("bn,bhpn->bhp", c_t.float(), state)
    yh = yh + tp.take(p["D"], (nh,), ctx, 0, lo, hi)[None, :, None] * xs.float()
    yh = yh.reshape(b, 1, nl * ph).to(cd)
    yh = _gated_norm(p["norm"], yh, z[..., lo * ph:hi * ph], cfg, di, lo * ph, hi * ph, cd, ctx)
    out = L.dense_rows(p["out_proj"], yh, di, d, lo * ph, hi * ph, cd, ctx)
    if nl < nh:
        out = tp.all_reduce(out, ctx)
    return out, {"conv": conv_buf[..., w_lo:w_hi] if w_hi - w_lo < cw else conv_buf,
                 "state": state}

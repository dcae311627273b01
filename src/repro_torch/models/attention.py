"""GQA attention: the self-attention prefill path through the
flash-attention kernel (K6), the differentiable blockwise self-attention of
the training forward, the KV-cache decode path, and cross-attention
(encoder-decoder).

Port of ``repro.models.attention``.

Layouts, as in the JAX package:
  hidden        (B, S, D)
  q             (B, S, KV, G, hd)   G = n_heads // n_kv_heads, head h = kv*G + g
  k, v          (B, S, KV, hd)
  decode cache  per layer {"k": (B, S, KV, hd), "v": ...} (bf16) + int position

The self-attention prefill folds the heads into the leading dimension and
calls ``kernels.flashattn.flash_attention``: MHA on (BH, S_q, hd) queries
at positions ``q_offset ..`` against (BH, S_kv, hd) keys (the TPU kernel's
self-attention when S_q = S_kv and the offset is 0). For G > 1 the K/V
heads are repeated G times first (a plain copy); folding the group into the
kernel's indexing is later work. Each function takes the residual layout
or the model group of ``repro_torch.distributed.tp`` (one rank's by
default): :func:`self_attention` splits the heads or the query rows
(``sharding.qkv_constraint``) and the decode paths split the KV slots. K6
has no backward: where autograd records
(a loss whose params require grad), self-attention takes
:func:`blockwise_attention` instead, JAX's ``multihead_attention`` (online
softmax over KV chunks, each chunk step recomputed in backward). Cross-
attention (K/V of another length) and the decode paths are plain PyTorch, as
JAX computes them outside any kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.distributed as dist

from ..distributed import sharding as shd
from ..distributed import tp
from ..kernels import flashattn as FA
from . import layers as L

Params = Dict[str, Any]

_DEFAULT_BLOCKS = {"q_block": 512, "kv_chunk": 512, "score_dtype": None}
#: Blockwise-attention knobs of the training forward (q block, kv chunk,
#: score dtype: None is fp32), as JAX's ``_BLOCK_CONFIG``. The online-softmax
#: carries m / l / acc stay fp32 whatever the score dtype.
_BLOCK_CONFIG = dict(_DEFAULT_BLOCKS)


def set_block_config(q_block=None, kv_chunk=None, score_dtype="keep"):
    if q_block is not None:
        _BLOCK_CONFIG["q_block"] = q_block
    if kv_chunk is not None:
        _BLOCK_CONFIG["kv_chunk"] = kv_chunk
    if score_dtype != "keep":
        _BLOCK_CONFIG["score_dtype"] = score_dtype


def reset_block_config():
    _BLOCK_CONFIG.update(_DEFAULT_BLOCKS)


def make_attention(gen, cfg, dtype, device, cross: bool = False) -> Params:
    """Q/K/V/O projections; a cross-attention block has the same params
    (its K/V project the encoder states)."""
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": L.make_dense(gen, d, cfg.n_heads * hd, dtype, device, bias=cfg.qkv_bias),
        "wk": L.make_dense(gen, d, cfg.n_kv_heads * hd, dtype, device, bias=cfg.qkv_bias),
        "wv": L.make_dense(gen, d, cfg.n_kv_heads * hd, dtype, device, bias=cfg.qkv_bias),
        "wo": L.make_dense(gen, cfg.n_heads * hd, d, dtype, device),
    }


def _split_heads(x, n_kv, group, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n_kv, group, hd)


def _qkv(p, cfg, x, kv_x, positions, kv_positions, compute_dtype):
    hd = cfg.head_dim
    n_kv = cfg.n_kv_heads
    group = cfg.n_heads // n_kv
    q = _split_heads(L.dense(p["wq"], x, compute_dtype), n_kv, group, hd)
    k = L.dense(p["wk"], kv_x, compute_dtype).reshape(*kv_x.shape[:2], n_kv, hd)
    v = L.dense(p["wv"], kv_x, compute_dtype).reshape(*kv_x.shape[:2], n_kv, hd)
    if cfg.use_rope:
        q = apply_rope_grouped(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def apply_rope_grouped(q, positions, theta):
    b, s, n_kv, g, hd = q.shape
    q2 = L.apply_rope(q.reshape(b, s, n_kv * g, hd), positions, theta)
    return q2.reshape(b, s, n_kv, g, hd)


# ---------------------------------------------------------------------------
# Self-attention (prefill) through K6
# ---------------------------------------------------------------------------


def multihead_attention(q, k, v, causal: bool, q_offset: int = 0):
    """q: (B,S,KV,G,hd); k, v: (B,S_kv,KV,hd) -> (B,S,KV,G,hd) in q's dtype:
    K6, the queries at positions ``q_offset ..`` of the keys' sequence (the
    causal mask is ``key <= q_offset + query``)."""
    b, s, n_kv, g, hd = q.shape
    s_kv = k.shape[1]
    bh = b * n_kv * g
    qf = q.permute(0, 2, 3, 1, 4).reshape(bh, s, hd)
    kf = k.permute(0, 2, 1, 3)                               # (B, KV, S_kv, hd)
    vf = v.permute(0, 2, 1, 3)
    if g > 1:
        # head h = kv*G + g reads K/V head kv
        kf = kf.repeat_interleave(g, dim=1)
        vf = vf.repeat_interleave(g, dim=1)
    out = FA.flash_attention(qf.contiguous(), kf.reshape(bh, s_kv, hd).contiguous(),
                             vf.reshape(bh, s_kv, hd).contiguous(), causal=causal,
                             q_offset=q_offset)
    return out.reshape(b, n_kv, g, s, hd).permute(0, 3, 1, 2, 4)


def _attend(q, k, v, causal: bool, q_offset: int = 0):
    """K6 (:func:`multihead_attention`), or :func:`blockwise_attention` where
    autograd records through q, k or v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        # JAX's self_attention passes 512 / 512, whatever set_block_config says
        return blockwise_attention(q, k, v, causal, q_block=512, kv_chunk=512,
                                   q_offset=q_offset)
    return multihead_attention(q, k, v, causal, q_offset)


def _rope_qk(cfg, q, k, q_pos, k_pos):
    if cfg.use_rope:
        q = apply_rope_grouped(q, q_pos, cfg.rope_theta)
        k = L.apply_rope(k, k_pos, cfg.rope_theta)
    return q, k


def self_attention(p, cfg, h, compute_dtype, causal: bool = True, lay=None):
    """Self-attention of ``h`` in the residual layout ``lay`` (one rank's by
    default), in the layout ``sharding.qkv_constraint`` asks for:

    * head-parallel (the KV heads split): the rank's KV heads with their G
      query heads each over the whole sequence; wq / wk / wv are its column
      blocks (head h = kv*G + g, so wq's block r holds KV heads r*KV/m ..),
      wo its row block, and the output a summand;
    * sequence-parallel: q of the residual's rows (RoPE at their absolute
      positions), K/V of the whole sequence, once per layer, on whole
      weights; the output is the residual's rows.

    K6 (``multihead_attention``), or :func:`blockwise_attention` where
    autograd records through q, k or v."""
    lay = lay or tp.layout(tp.ONE, h.shape[1])
    ctx, cd = lay.ctx, compute_dtype
    hd, n_kv, n_h, d = cfg.head_dim, cfg.n_kv_heads, cfg.n_heads, cfg.d_model
    g = n_h // n_kv
    b, s = h.shape[0], lay.full
    _, kspec = shd.qkv_constraint(ctx.mesh)((b, s, n_kv, g, hd), (b, s, n_kv, hd))
    hf = tp.to_whole(h, lay)
    pos = torch.arange(s, device=h.device)[None, :]
    if kspec[2] == "model":
        k_lo, k_hi = tp.span(ctx, n_kv)
        nk = k_hi - k_lo
        q = L.dense_cols(p["wq"], hf, d, n_h * hd, k_lo * g * hd, k_hi * g * hd, cd, ctx)
        k = L.dense_cols(p["wk"], hf, d, n_kv * hd, k_lo * hd, k_hi * hd, cd, ctx)
        v = L.dense_cols(p["wv"], hf, d, n_kv * hd, k_lo * hd, k_hi * hd, cd, ctx)
        q, k = _rope_qk(cfg, q.reshape(b, s, nk, g, hd), k.reshape(b, s, nk, hd), pos, pos)
        out = _attend(q, k, v.reshape(b, s, nk, hd), causal)
        out = out.reshape(b, s, nk * g * hd).to(cd)
        return tp.from_partial(L.dense_rows(p["wo"], out, n_h * hd, d, k_lo * g * hd,
                                            k_hi * g * hd, cd, ctx), lay)
    q = L.dense_cols(p["wq"], h, d, n_h * hd, 0, n_h * hd, cd, ctx)
    k = L.dense_cols(p["wk"], hf, d, n_kv * hd, 0, n_kv * hd, cd, ctx)
    v = L.dense_cols(p["wv"], hf, d, n_kv * hd, 0, n_kv * hd, cd, ctx)
    q, k = _rope_qk(cfg, q.reshape(b, lay.n, n_kv, g, hd), k.reshape(b, s, n_kv, hd),
                    pos[:, lay.lo:lay.lo + lay.n], pos)
    out = _attend(q, k, v.reshape(b, s, n_kv, hd), causal, lay.lo)
    out = out.reshape(b, lay.n, n_h * hd).to(cd)
    return L.dense_cols(p["wo"], out, n_h * hd, d, 0, d, cd, ctx)


# ---------------------------------------------------------------------------
# Blockwise self-attention (training forward): plain PyTorch, differentiable
# ---------------------------------------------------------------------------


def _chunk_step(m, l, acc, q_blk, k_c, v_c, q_pos, kv_pos, causal: bool, scale: float, sd):
    """One KV chunk of the online softmax: (m, l, acc) -> (m, l, acc), the
    scores in ``sd``."""
    neg = -1e30 if sd == torch.float32 else -3e38
    s = torch.einsum("bqkgd,bckd->bkgqc", q_blk.to(sd), k_c.to(sd)) * scale
    if causal:
        s = s.masked_fill(q_pos[:, None] < kv_pos[None, :], neg)
    m_new = torch.maximum(m, s.amax(dim=-1).float())
    p = torch.exp(s - m_new[..., None].to(sd))
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1).float()
    pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(v_c.dtype), v_c)
    return m_new, l_new, acc * corr[..., None] + pv.float()


def _block_attend(q_blk, k, v, q_start: int, kc: int, n_ch: int, causal: bool, scale: float,
                  sd):
    """Online-softmax attention of one query block over the first ``n_ch``
    KV chunks of length ``kc``; each chunk step is recomputed in backward
    (JAX's ``@jax.checkpoint``), so no (q_block x kc) probability block is
    kept for it. -> (b, bq, n_kv, g, hd) fp32."""
    b, bq, n_kv, g, hd = q_blk.shape
    dev = q_blk.device
    q_pos = q_start + torch.arange(bq, device=dev)
    m = torch.full((b, n_kv, g, bq), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((b, n_kv, g, bq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, n_kv, g, bq, hd), dtype=torch.float32, device=dev)
    for c in range(n_ch):
        kv_pos = c * kc + torch.arange(kc, device=dev)
        m, l, acc = L.remat(_chunk_step, m, l, acc, q_blk, k[:, c * kc:(c + 1) * kc],
                            v[:, c * kc:(c + 1) * kc], q_pos, kv_pos, causal, scale, sd)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4)


def blockwise_attention(q, k, v, causal: bool, q_block: int | None = None,
                        kv_chunk: int | None = None, q_offset: int = 0):
    """q: (B,S,KV,G,hd); k, v: (B,S_kv,KV,hd) -> (B,S,KV,G,hd) fp32.

    JAX's ``multihead_attention``: query blocks of ``q_block`` (one block
    when it does not divide S), KV chunks of the largest length up to
    ``kv_chunk`` that tiles both the KV and the query block; a causal query
    block only visits the KV prefix it can see. The queries sit at positions
    ``q_offset ..`` of the keys' sequence (a multiple of the KV chunk)."""
    q_block = q_block or _BLOCK_CONFIG["q_block"]
    kv_chunk = kv_chunk or _BLOCK_CONFIG["kv_chunk"]
    sd = _BLOCK_CONFIG["score_dtype"] or torch.float32
    s, hd = q.shape[1], q.shape[-1]
    s_kv = k.shape[1]
    # the scale as the score dtype holds it, as JAX casts it
    scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=sd))
    qb = min(q_block, s)
    if s % qb:
        qb = s
    n_q = s // qb
    kc = min(kv_chunk, qb, s_kv)
    while s_kv % kc or qb % kc:
        kc -= 1
    if q_offset % kc:
        raise ValueError(f"a query offset of {q_offset} is no multiple of the KV chunk {kc}")
    outs = []
    for i in range(n_q):
        start = q_offset + i * qb
        hi = min(start + qb, s_kv) if causal else s_kv
        outs.append(_block_attend(q[:, i * qb:(i + 1) * qb], k, v, start, kc,
                                  max(hi // kc, 1), causal, scale, sd))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# Cross-attention (prefill): plain PyTorch
# ---------------------------------------------------------------------------


def whole_params(p, cfg, ctx):
    """An attention block's params whole, from the rank's stored blocks."""
    d, hd = cfg.d_model, cfg.head_dim
    cols = {"wq": cfg.n_heads * hd, "wk": cfg.n_kv_heads * hd, "wv": cfg.n_kv_heads * hd}
    out = {}
    for name, sub in p.items():
        d_in, d_out = (cfg.n_heads * hd, d) if name == "wo" else (d, cols[name])
        out[name] = {"w": tp.whole(sub["w"], (d_in, d_out), ctx)}
        if "b" in sub:
            out[name]["b"] = tp.whole(sub["b"], (d_out,), ctx)
    return out


def cross_attention(p, cfg, x, enc_states, compute_dtype, q_offset: int = 0, ctx=tp.ONE):
    """x: (B, S, D) attends to enc_states (B, S_enc, D), unmasked; x's rows
    sit at positions ``q_offset ..``. No rule splits it: on a model group it
    runs on whole weights (:func:`whole_params`) and the whole encoder
    states, for the residual's own rows (a query row attends alone).

    JAX's blockwise XLA attention in one block: fp32 scores, the
    unnormalised p in the compute dtype for P.V, divided by the fp32 row sum
    at the end."""
    p = whole_params(p, cfg, ctx)
    b, s, _ = x.shape
    positions = q_offset + torch.arange(s, device=x.device)[None, :]
    enc_pos = torch.arange(enc_states.shape[1], device=x.device)[None, :]
    q, k, v = _qkv(p, cfg, x, enc_states, positions, enc_pos, compute_dtype)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    sc = torch.einsum("bqkgd,bckd->bkgqc", q.float(), k.float()) * scale
    e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    pv = torch.einsum("bkgqc,bckd->bkgqd", e.to(v.dtype), v).float()
    out = (pv / torch.clamp(e.sum(dim=-1), min=1e-30)[..., None]).permute(0, 3, 1, 2, 4)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim).to(compute_dtype)
    return L.dense(p["wo"], out, compute_dtype)


# ---------------------------------------------------------------------------
# Decode path (one new token against a KV cache)
# ---------------------------------------------------------------------------


def make_cache(cfg, batch: int, seq: int, device, dtype=torch.bfloat16):
    shape = (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cols_gathered(p, x, d_in: int, d_out: int, compute_dtype, ctx):
    """``dense(p, x)`` of a one-token x from the column blocks: each rank
    its columns, then an all-gather of the (B, 1, d_out) result."""
    lo, hi = tp.span(ctx, d_out)
    y = L.dense_cols(p, x, d_in, d_out, lo, hi, compute_dtype, ctx)
    return tp.all_gather(y, -1, ctx) if hi - lo < d_out else y


def _rows_reduced(p, x, d_in: int, d_out: int, compute_dtype, ctx):
    """``dense(p, x)`` from the row blocks: each rank its rows' summand, then
    an all-reduce."""
    lo, hi = tp.span(ctx, d_in)
    if hi - lo == d_in:
        return L.dense({k: tp.whole(v, (d_in, d_out) if k == "w" else (d_out,), ctx)
                        for k, v in p.items()}, x, compute_dtype)
    y = tp.all_reduce(L.dense_rows(p, x[..., lo:hi], d_in, d_out, lo, hi, compute_dtype, ctx),
                      ctx)
    return L.add_bias(p, y, d_out, compute_dtype, ctx)


def _softmax_pv(s, vals, ctx, split: bool):
    """softmax(s) @ vals, fp32 scores (b, kv, g, 1, n), vals (b, n, kv, hd).
    Over key slots split across the group (``split``): the global row max
    and sum of exp all-reduced, p rounded to the cache's dtype as the
    whole-slot path rounds it, the fp32 products all-reduced and rounded
    once."""
    if not split:
        pattn = torch.softmax(s, dim=-1)
        return torch.einsum("bkgqs,bskd->bqkgd", pattn.to(vals.dtype), vals)
    mx = tp.all_reduce(s.amax(dim=-1, keepdim=True), ctx, dist.ReduceOp.MAX)
    e = torch.exp(s - mx)
    pattn = (e / tp.all_reduce(e.sum(dim=-1, keepdim=True), ctx)).to(vals.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", pattn.float(), vals.float())
    return tp.all_reduce(out, ctx).to(vals.dtype)


def decode_self_attention(p, cfg, x, cache, position: int, compute_dtype, ctx=tp.ONE,
                          seq_len=None):
    """x: (B, 1, D); cache k/v: (B, S, KV, hd), or on a model group this
    rank's block of ``seq_len`` slots (``sharding.cache_specs``: split along
    the slots when they divide, else whole); position: int.

    Returns (out (B,1,D), cache). q, k and v come from the column blocks
    (all-gathered: the slots hold every head). The new token's K/V
    overwrite slot ``min(position, S - 1)`` of the cache in place, on the
    rank that holds it (JAX returns an updated copy; its
    ``dynamic_update_slice`` clamps the slot the same way). RoPE and the mask
    take the unclamped position: past the end every slot is valid. Each
    rank scores its slots and the softmax is merged over the group; wo is
    the row block.
    """
    b = x.shape[0]
    hd, n_kv, n_h, d, cd = cfg.head_dim, cfg.n_kv_heads, cfg.n_heads, cfg.d_model, compute_dtype
    g = n_h // n_kv
    seq_len = seq_len or cache["k"].shape[1]
    pos = torch.full((b, 1), position, dtype=torch.long, device=x.device)
    q = _cols_gathered(p["wq"], x, d, n_h * hd, cd, ctx).reshape(b, 1, n_kv, g, hd)
    k_new = _cols_gathered(p["wk"], x, d, n_kv * hd, cd, ctx).reshape(b, 1, n_kv, hd)
    v_new = _cols_gathered(p["wv"], x, d, n_kv * hd, cd, ctx).reshape(b, 1, n_kv, hd)
    q, k_new = _rope_qk(cfg, q, k_new, pos, pos)
    k_cache, v_cache = cache["k"], cache["v"]
    lo, hi = tp.span(ctx, seq_len)
    slot = min(position, seq_len - 1)
    if lo <= slot < hi:
        k_cache[:, slot - lo] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, slot - lo] = v_new[:, 0].to(v_cache.dtype)
    s = torch.einsum("bqkgd,bskd->bkgqs", q, k_cache.to(q.dtype))
    s = s.float() * (1.0 / math.sqrt(hd))
    # mask out slots beyond the current position (cache may be part-filled)
    invalid = lo + torch.arange(hi - lo, device=x.device) > position
    s = s.masked_fill(invalid, FA.MASKED)
    out = _softmax_pv(s, v_cache, ctx, hi - lo < seq_len)
    out = out.reshape(b, 1, n_h * hd).to(cd)
    return _rows_reduced(p["wo"], out, n_h * hd, d, cd, ctx), cache


def decode_cross_attention(p, cfg, x, enc_k, enc_v, compute_dtype, ctx=tp.ONE, enc_len=None):
    """Cross-attention of x (B, 1, D) against precomputed encoder K/V
    (B, S_enc, KV, hd), on a model group this rank's block of ``enc_len``
    slots."""
    b = x.shape[0]
    hd, n_kv, n_h, d, cd = cfg.head_dim, cfg.n_kv_heads, cfg.n_heads, cfg.d_model, compute_dtype
    q = _cols_gathered(p["wq"], x, d, n_h * hd, cd, ctx).reshape(b, 1, n_kv, n_h // n_kv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", q, enc_k.to(q.dtype))
    s = s.float() * (1.0 / math.sqrt(hd))
    out = _softmax_pv(s, enc_v, ctx, enc_k.shape[1] < (enc_len or enc_k.shape[1]))
    out = out.reshape(b, 1, n_h * hd).to(cd)
    return _rows_reduced(p["wo"], out, n_h * hd, d, cd, ctx)

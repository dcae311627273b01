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
calls ``kernels.flashattn.flash_attention``, whose contract is the TPU
kernel's: MHA on (BH, S, hd) with K/V as long as q. For G > 1 the K/V heads
are repeated G times first (a plain copy); folding the group into the
kernel's indexing is later work. K6 has no backward: where autograd records
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


def multihead_attention(q, k, v, causal: bool):
    """q: (B,S,KV,G,hd); k, v: (B,S,KV,hd) -> (B,S,KV,G,hd) in q's dtype.
    Self-attention only (as many keys as queries): K6's contract."""
    b, s, n_kv, g, hd = q.shape
    if k.shape[1] != s:
        raise ValueError(f"K6 takes as many keys as queries, got {k.shape[1]} and {s}; "
                         "cross-attention goes through cross_attention")
    bh = b * n_kv * g
    qf = q.permute(0, 2, 3, 1, 4).reshape(bh, s, hd)
    kf = k.permute(0, 2, 1, 3)                               # (B, KV, S, hd)
    vf = v.permute(0, 2, 1, 3)
    if g > 1:
        # head h = kv*G + g reads K/V head kv
        kf = kf.repeat_interleave(g, dim=1)
        vf = vf.repeat_interleave(g, dim=1)
    out = FA.flash_attention(qf.contiguous(), kf.reshape(bh, s, hd).contiguous(),
                             vf.reshape(bh, s, hd).contiguous(), causal=causal)
    return out.reshape(b, n_kv, g, s, hd).permute(0, 3, 1, 2, 4)


def self_attention(p, cfg, x, compute_dtype, causal: bool = True):
    """K6 (``multihead_attention``), or :func:`blockwise_attention` where
    autograd records through q, k or v."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(p, cfg, x, x, positions, positions, compute_dtype)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        # JAX's self_attention passes 512 / 512, whatever set_block_config says
        out = blockwise_attention(q, k, v, causal, q_block=512, kv_chunk=512)
    else:
        out = multihead_attention(q, k, v, causal)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim).to(compute_dtype)
    return L.dense(p["wo"], out, compute_dtype)


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
                        kv_chunk: int | None = None):
    """q: (B,S,KV,G,hd); k, v: (B,S_kv,KV,hd) -> (B,S,KV,G,hd) fp32.

    JAX's ``multihead_attention``: query blocks of ``q_block`` (one block
    when it does not divide S), KV chunks of the largest length up to
    ``kv_chunk`` that tiles both the KV and the query block; a causal query
    block only visits the KV prefix it can see."""
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
    outs = []
    for i in range(n_q):
        hi = min((i + 1) * qb, s_kv) if causal else s_kv
        outs.append(_block_attend(q[:, i * qb:(i + 1) * qb], k, v, i * qb, kc,
                                  max(hi // kc, 1), causal, scale, sd))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# Cross-attention (prefill): plain PyTorch
# ---------------------------------------------------------------------------


def cross_attention(p, cfg, x, enc_states, compute_dtype):
    """x: (B, S, D) attends to enc_states (B, S_enc, D), unmasked.

    JAX's blockwise XLA attention in one block: fp32 scores, the
    unnormalised p in the compute dtype for P.V, divided by the fp32 row sum
    at the end."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
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


def decode_self_attention(p, cfg, x, cache, position: int, compute_dtype):
    """x: (B, 1, D); cache k/v: (B, S, KV, hd); position: int.

    Returns (out (B,1,D), cache). The new token's K/V overwrite slot
    ``min(position, S - 1)`` of the cache in place (JAX returns an updated
    copy; its ``dynamic_update_slice`` clamps the slot the same way). RoPE
    and the mask take the unclamped position: past the end every slot is
    valid.
    """
    b = x.shape[0]
    hd = cfg.head_dim
    pos = torch.full((b, 1), position, dtype=torch.long, device=x.device)
    q, k_new, v_new = _qkv(p, cfg, x, x, pos, pos, compute_dtype)
    k_cache, v_cache = cache["k"], cache["v"]
    slot = min(position, k_cache.shape[1] - 1)
    k_cache[:, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v_new[:, 0].to(v_cache.dtype)

    s = torch.einsum("bqkgd,bskd->bkgqs", q, k_cache.to(q.dtype))
    s = s.float() * (1.0 / math.sqrt(hd))
    # mask out slots beyond the current position (cache may be part-filled)
    invalid = torch.arange(k_cache.shape[1], device=x.device) > position
    s = s.masked_fill(invalid, FA.MASKED)
    pattn = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", pattn.to(v_cache.dtype), v_cache)
    out = out.reshape(b, 1, cfg.n_heads * hd).to(compute_dtype)
    return L.dense(p["wo"], out, compute_dtype), cache


def decode_cross_attention(p, cfg, x, enc_k, enc_v, compute_dtype):
    """Cross-attention of x (B, 1, D) against precomputed encoder K/V
    (B, S_enc, KV, hd)."""
    b = x.shape[0]
    hd, n_kv = cfg.head_dim, cfg.n_kv_heads
    q = _split_heads(L.dense(p["wq"], x, compute_dtype), n_kv, cfg.n_heads // n_kv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", q, enc_k.to(q.dtype))
    s = s.float() * (1.0 / math.sqrt(hd))
    pattn = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", pattn.to(enc_v.dtype), enc_v)
    out = out.reshape(b, 1, cfg.n_heads * hd).to(compute_dtype)
    return L.dense(p["wo"], out, compute_dtype)

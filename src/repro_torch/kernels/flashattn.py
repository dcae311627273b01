"""Flash attention (kernel K6): softmax attention with an online softmax,
optionally causal, on ``(BH, S, hd)`` with the heads folded (MHA). The
queries may be a block of rows of a longer sequence: ``(BH, S_q, hd)`` at
positions ``q_offset ..`` against ``(BH, S_kv, hd)`` keys (the causal mask
is ``key <= q_offset + query``): the sequence-parallel prefill's layout.

Port of ``repro.kernels.flashattn`` (``flashattn.flash_attention_pallas``,
``ops.flash_attention``, ``ref.attention`` and ``hbm_traffic_model``).
``flash_attention`` dispatches on the device of its input: a CPU tensor takes
the plain version beside the wrapper, a CUDA tensor launches
``csrc/flashattn.cu`` (or raises). There is no fallback from one to the
other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import counts

#: head sizes K6 is built for (Qwen1.5/SmolLM 64, Qwen2/Phi-3 128).
HEAD_DIMS = (64, 128)
#: the score given to a masked (query, key) pair, as in the TPU kernel.
MASKED = -1e30

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_float, ctypes.c_void_p)
_SIGNATURES = {"flash_attention_f32": _ARGS, "flash_attention_bf16": _ARGS}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, q_offset: int = 0) -> torch.Tensor:
    """The TPU kernel's arithmetic in one block: q cast to fp32 and scaled by
    fp32(1/sqrt(hd)), scores in fp32, -1e30 where masked (``key > q_offset +
    query``), fp32 P.V over ``max(l, 1e-30)``, the result in q's dtype. (An
    online softmax over key chunks gives the same function: masked scores
    add exp(-1e30 - m) = 0.)"""
    s_len, hd = q.shape[-2:]
    qs = q.float() * (1.0 / math.sqrt(hd))
    s = qs @ k.float().transpose(-1, -2)
    if causal:
        qpos = q_offset + torch.arange(s_len, device=q.device)
        kpos = torch.arange(k.shape[-2], device=q.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], MASKED)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return ((p @ v.float()) / torch.clamp(l, min=1e-30)).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False) -> torch.Tensor:
    """Naive softmax oracle (``repro.kernels.flashattn.ref.attention``):
    (BH, S, hd) -> (BH, S, hd)."""
    s_len, hd = q.shape[-2:]
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        mask = torch.ones((s_len, s_len), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, torch.full_like(scores, MASKED))
    p = torch.softmax(scores, dim=-1)
    return (p @ v.float()).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int) -> None:
    if (q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or k.shape[0] != q.shape[0]
            or k.shape[2] != q.shape[2]):
        raise ValueError("flash_attention takes q (BH, S_q, hd) and k, v (BH, S_kv, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q_offset < 0 or q_offset + q.shape[1] > k.shape[1]:
        raise ValueError(f"queries at {q_offset} .. {q_offset + q.shape[1]} lie outside the "
                         f"{k.shape[1]} keys")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention takes q, k, v on one device")


def _check_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """K6's own demands (the CUDA and the fake route)."""
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head size {HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
         q_offset: int = 0):
    """(flops, bytes) one K6 call needs: 4 hd per (query, key) pair that is
    not masked; q, k, v read once and the output written once."""
    bh, s_q, hd = q.shape
    s_kv = k.shape[1]
    pairs = s_q * q_offset + s_q * (s_q + 1) / 2 if causal else s_q * s_kv
    return 4.0 * hd * bh * pairs, float(2 * q.numel() * q.element_size()
                                        + k.numel() * k.element_size()
                                        + v.numel() * v.element_size())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, q_offset: int = 0) -> torch.Tensor:
    """(BH, S_q, hd) MHA attention against (BH, S_kv, hd) keys, the queries
    at positions ``q_offset ..`` (S_q = S_kv and 0: self-attention), fp32 or
    bf16, output in q's dtype. On the
    card K6 takes hd 64 or 128 and contiguous tensors of one dtype (bf16 ones
    16-byte aligned: the kernel copies 16-byte chunks); it raises on anything
    else. K6 has no backward: where autograd records through q, k or v it
    raises, on any device, rather than return a result without a gradient
    (the training forward takes ``models.attention.blockwise_attention``)."""
    _check(q, k, v, q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention (K6) has no backward; differentiate "
                           "models.attention.blockwise_attention instead")
    if counts.is_fake(q):
        _check_kernel(q, k, v)
        flops, nb = cost(q, k, v, causal, q_offset)
        counts.fake_launch("flash_attention", flops, nb, tensor_core=q.dtype == torch.bfloat16)
        return torch.empty_like(q)
    if q.device.type == "cpu":
        counts.bump("plain:flash_attention")
        return flash_attention_plain(q, k, v, causal, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")
    bh, s_len, hd = q.shape
    _check_kernel(q, k, v)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention bf16 kernel needs 16-byte aligned q, k, v")
    out = torch.empty_like(q)
    lib = _build.library("flashattn", _SIGNATURES)
    fn = lib.flash_attention_bf16 if q.dtype == torch.bfloat16 else lib.flash_attention_f32
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s_len,
                k.shape[1], int(q_offset), hd, int(bool(causal)), 1.0 / math.sqrt(hd),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
    counts.bump("flash_attention")
    return out


def hbm_traffic_model(s: int, hd: int, n_heads: int, batch: int,
                      q_block: int = 512, bytes_per_el: int = 2) -> dict:
    """Analytic HBM traffic of one attention layer (bytes), as the JAX
    package models it for the TPU kernel.

    xla  : blockwise attention that round-trips every fp32 score and
           probability tile: ~ 3 * 4B * B*H*S^2 + K/V rereads.
    flash: q/k/v read once per (head, q-block) step, scores on chip:
           B*H * (S*hd*(1 + 2*S/q_block)) elements.
    """
    bh = batch * n_heads
    score_bytes = 4
    xla = bh * (3 * score_bytes * s * s
                + 2 * bytes_per_el * s * hd * (s / q_block)
                + 2 * bytes_per_el * s * hd)
    flash = bh * bytes_per_el * (s * hd
                                 + 2 * s * hd * (s / (q_block * 64) + 1)
                                 + s * hd)
    return {"xla_bytes": xla, "flash_bytes": flash, "ratio": xla / flash}

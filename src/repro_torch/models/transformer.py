"""Transformer LM assembly: segments, per-layer params, the prefill stack and
the decode stack.

Port of ``repro.models.transformer`` for the signature ``("attn", "dense")``
(the dense family); SSM and MoE layers wait for ROADMAP A20. Layers are
grouped into SEGMENTS, maximal runs of layers with identical structure, as
in the JAX package. JAX stacks a segment's params on a leading axis and
scans over them; here a segment holds a list over its repeats,
``p["seg<i>"]["sub<j>"][r]``, the layout of JAX's decode cache, and the
stack is a Python loop (no remat: inference only).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from . import attention as A
from . import layers as L

Params = Dict[str, Any]
Sig = Tuple[str, str]

PORTED_SIGNATURE: Sig = ("attn", "dense")


def segments(cfg) -> List[Tuple[int, List[Sig]]]:
    """[(n_repeat, [per-sublayer signature])] covering cfg.n_layers."""
    sigs = []
    for l in range(cfg.n_layers):
        mixer = "attn" if cfg.is_attn_layer(l) else "ssm"
        if cfg.family == "ssm":
            mlp = "none"
        elif cfg.is_moe_layer(l):
            mlp = "moe"
        else:
            mlp = "dense"
        sigs.append((mixer, mlp))

    if cfg.family == "hybrid" and cfg.attn_period:
        period = cfg.attn_period
        assert cfg.n_layers % period == 0
        pattern = sigs[:period]
        for i in range(0, cfg.n_layers, period):
            assert sigs[i: i + period] == pattern, "aperiodic hybrid pattern"
        return [(cfg.n_layers // period, pattern)]

    # maximal homogeneous runs
    segs: List[Tuple[int, List[Sig]]] = []
    for sig in sigs:
        if segs and segs[-1][1] == [sig]:
            segs[-1] = (segs[-1][0] + 1, segs[-1][1])
        else:
            segs.append((1, [sig]))
    return segs


def _check_sig(sig: Sig) -> None:
    if sig != PORTED_SIGNATURE:
        raise NotImplementedError(f"layer signature {sig}: only {PORTED_SIGNATURE} "
                                  "(the dense family) is ported; SSM and MoE layers "
                                  "wait for ROADMAP A20")


# ---------------------------------------------------------------------------
# Per-layer init / apply
# ---------------------------------------------------------------------------


def make_sublayer(gen, cfg, sig: Sig, dtype, device) -> Params:
    _check_sig(sig)
    norm_fn = L.make_norm if cfg.rmsnorm else L.make_layernorm
    p: Params = {"norm1": norm_fn(cfg.d_model, dtype, device),
                 "mixer": A.make_attention(gen, cfg, dtype, device),
                 "norm2": norm_fn(cfg.d_model, dtype, device)}
    # fine-grained MoE models use a wide dense FFN on dense layers
    dff = cfg.d_ff if cfg.d_ff else cfg.moe_d_ff
    p["mlp"] = L.make_mlp(gen, cfg.d_model, dff, dtype, device, act=cfg.act)
    return p


def sublayer_apply(p: Params, cfg, sig: Sig, x, compute_dtype, causal=True):
    _check_sig(sig)
    h = L.norm_apply(p["norm1"], x, cfg.norm_eps, compute_dtype)
    x = x + A.self_attention(p["mixer"], cfg, h, compute_dtype, causal=causal)
    h = L.norm_apply(p["norm2"], x, cfg.norm_eps, compute_dtype)
    return x + L.mlp(p["mlp"], h, cfg.act, compute_dtype)


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------


def make_stack(gen, cfg, dtype, device) -> Params:
    """Params: {"seg<i>": {"sub<j>": [per-repeat params]}}."""
    p: Params = {}
    for si, (n_rep, sigs) in enumerate(segments(cfg)):
        per = [[make_sublayer(gen, cfg, sig, dtype, device) for sig in sigs]
               for _ in range(n_rep)]
        p[f"seg{si}"] = {f"sub{j}": [per[r][j] for r in range(n_rep)]
                         for j in range(len(sigs))}
    return p


def stack_apply(p: Params, cfg, x, compute_dtype, causal=True):
    """Run every layer in order (a Python loop; no remat for inference)."""
    for si, (n_rep, sigs) in enumerate(segments(cfg)):
        seg = p[f"seg{si}"]
        for r in range(n_rep):
            for j, sig in enumerate(sigs):
                x = sublayer_apply(seg[f"sub{j}"][r], cfg, sig, x, compute_dtype,
                                   causal=causal)
    return x


# ---------------------------------------------------------------------------
# Decode stacks (one KV buffer pair per layer)
# ---------------------------------------------------------------------------


def make_stack_cache(cfg, batch: int, seq: int, device, dtype=None) -> Params:
    """Cache mirroring the segment structure: ``cache["seg<i>"]["sub<j>"][r]``
    is layer r's ``{"k", "v"}``, separate per-layer buffers updated in place
    (bf16 unless ``dtype`` says otherwise, as in the JAX package)."""
    dtype = dtype or torch.bfloat16
    cache: Params = {}
    for si, (n_rep, sigs) in enumerate(segments(cfg)):
        seg: Params = {}
        for j, sig in enumerate(sigs):
            _check_sig(sig)
            seg[f"sub{j}"] = [A.make_cache(cfg, batch, seq, device, dtype)
                              for _ in range(n_rep)]
        cache[f"seg{si}"] = seg
    return cache


def stack_decode(p: Params, cfg, x, cache, position: int, compute_dtype):
    """One decode step through all layers; returns (x, cache)."""
    for si, (n_rep, sigs) in enumerate(segments(cfg)):
        seg_p, seg_c = p[f"seg{si}"], cache[f"seg{si}"]
        for r in range(n_rep):
            for j, sig in enumerate(sigs):
                _check_sig(sig)
                sp = seg_p[f"sub{j}"][r]
                hn = L.norm_apply(sp["norm1"], x, cfg.norm_eps, compute_dtype)
                out, seg_c[f"sub{j}"][r] = A.decode_self_attention(
                    sp["mixer"], cfg, hn, seg_c[f"sub{j}"][r], position, compute_dtype)
                x = x + out
                hn = L.norm_apply(sp["norm2"], x, cfg.norm_eps, compute_dtype)
                x = x + L.mlp(sp["mlp"], hn, cfg.act, compute_dtype)
    return x, cache

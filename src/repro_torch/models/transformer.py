"""Transformer / SSM / hybrid LM assembly: segments, per-layer params, the
prefill stack and the decode stack.

Port of ``repro.models.transformer``. Layers are grouped into SEGMENTS,
maximal runs of layers with identical structure, as in the JAX package; a
segment body may hold several different sub-layers (the hybrid's one
periodic segment, Jamba's 8-layer period). JAX stacks a segment's params on
a leading axis and scans over them; here a segment holds a list over its
repeats, ``p["seg<i>"]["sub<j>"][r]``, the layout of JAX's decode cache, and
the stack is a Python loop. Where autograd records, each repeat of a segment
body is recomputed in backward, and so is each MoE block inside it (JAX's
``remat=True`` and its ``jax.checkpoint`` of the MoE block).

Layer signature: (mixer, mlp) with mixer in {"attn", "ssm"} and mlp in
{"dense", "moe", "none"}.

A layer takes the residual stream in the layout
``sharding.residual_constraint`` gives it on its model group (a
``tp.Layout`` of ``repro_torch.distributed.tp``; one rank's holds the whole
sequence) and returns it in the same one; each mixer and MLP splits its
work over the group by its own rule.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..distributed import tp
from . import attention as A
from . import layers as L
from . import moe as M
from . import ssm as S

Params = Dict[str, Any]
Sig = Tuple[str, str]


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


# ---------------------------------------------------------------------------
# Per-layer init / apply
# ---------------------------------------------------------------------------


def make_sublayer(gen, cfg, sig: Sig, dtype, device, cross: bool = False) -> Params:
    mixer, mlp_kind = sig
    norm_fn = L.make_norm if cfg.rmsnorm else L.make_layernorm
    p: Params = {"norm1": norm_fn(cfg.d_model, dtype, device)}
    if mixer == "attn":
        p["mixer"] = A.make_attention(gen, cfg, dtype, device)
    else:
        p["mixer"] = S.make_ssm(gen, cfg, dtype, device)
    if cross:
        p["norm_cross"] = norm_fn(cfg.d_model, dtype, device)
        p["cross"] = A.make_attention(gen, cfg, dtype, device, cross=True)
    if mlp_kind != "none":
        p["norm2"] = norm_fn(cfg.d_model, dtype, device)
        if mlp_kind == "moe":
            p["mlp"] = M.make_moe(gen, cfg, dtype, device)
        else:
            # fine-grained MoE models use a wide dense FFN on dense layers
            dff = cfg.d_ff if cfg.d_ff else cfg.moe_d_ff
            p["mlp"] = L.make_mlp(gen, cfg.d_model, dff, dtype, device, act=cfg.act)
    return p


def sublayer_apply(p: Params, cfg, sig: Sig, x, compute_dtype, causal=True,
                   enc_states=None, lay=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer: (x, MoE aux loss, 0 for other layers). ``lay``: x's
    residual layout (one rank's by default); norms on whole weights, the
    mixer and the MLP by their rules."""
    lay = lay or tp.layout(tp.ONE, x.shape[1])
    mixer, mlp_kind = sig
    ctx, cd, d, eps = lay.ctx, compute_dtype, cfg.d_model, cfg.norm_eps
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.norm_apply(L.norm_whole(p["norm1"], d, ctx), x, eps, cd)
    if mixer == "attn":
        h = A.self_attention(p["mixer"], cfg, h, cd, causal, lay)
    else:
        h = S.ssm_block(p["mixer"], cfg, h, cd, lay)
    x = x + h
    if "cross" in p and enc_states is not None:
        h = L.norm_apply(L.norm_whole(p["norm_cross"], d, ctx), x, eps, cd)
        x = x + A.cross_attention(p["cross"], cfg, h, enc_states, cd, lay.lo, ctx)
    if mlp_kind != "none":
        h = L.norm_apply(L.norm_whole(p["norm2"], d, ctx), x, eps, cd)
        if mlp_kind == "moe":
            # recompute the dispatch/combine one-hots in backward instead of
            # saving them (they dominate MoE activation memory)
            h, aux = L.remat(lambda hh: M.moe_block(p["mlp"], cfg, hh, cd, lay), h)
        else:
            h = L.mlp(p["mlp"], h, cfg.act, cd, cfg.d_ff or cfg.moe_d_ff, lay)
        x = x + h
    return x, aux


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------


def make_stack(gen, cfg, dtype, device, cross: bool = False) -> Params:
    """Params: {"seg<i>": {"sub<j>": [per-repeat params]}}."""
    p: Params = {}
    for si, (n_rep, sigs) in enumerate(segments(cfg)):
        per = [[make_sublayer(gen, cfg, sig, dtype, device, cross=cross) for sig in sigs]
               for _ in range(n_rep)]
        p[f"seg{si}"] = {f"sub{j}": [per[r][j] for r in range(n_rep)]
                         for j in range(len(sigs))}
    return p


def stack_apply(p: Params, cfg, x, compute_dtype, causal=True, enc_states=None, lay=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run every layer in order; returns (x, the sum of the MoE aux losses).
    Where autograd records, each repeat of a segment body is recomputed in
    backward. ``lay``: x's residual layout (one rank's by default; each
    layer body returns the residual in it: ``sharding.residual_constraint``)."""
    lay = lay or tp.layout(tp.ONE, x.shape[1])
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, (n_rep, sigs) in enumerate(segments(cfg)):
        seg = p[f"seg{si}"]
        for r in range(n_rep):
            # the loop's variables bound now: backward recomputes after the loop
            def body(h, aux, seg=seg, sigs=sigs, r=r):
                for j, sig in enumerate(sigs):
                    h, a = sublayer_apply(seg[f"sub{j}"][r], cfg, sig, h, compute_dtype,
                                          causal=causal, enc_states=enc_states, lay=lay)
                    aux = aux + a
                return h, aux

            x, aux_total = L.remat(body, x, aux_total)
    return x, aux_total


# ---------------------------------------------------------------------------
# Decode stacks (separate per-layer buffers, updated in place)
# ---------------------------------------------------------------------------


def make_stack_cache(cfg, batch: int, seq: int, device, cross_seq: int = 0,
                     dtype=None) -> Params:
    """Cache mirroring the segment structure: ``cache["seg<i>"]["sub<j>"][r]``
    is layer r's ``{"k", "v"}`` (bf16 unless ``dtype`` says otherwise, as in
    the JAX package), ``{"self": {"k", "v"}, "cross": {"k", "v"}}`` with
    ``cross_seq`` encoder slots, or an SSM layer's fp32 ``{"conv", "state"}``."""
    dtype = dtype or torch.bfloat16

    def one(mixer):
        if mixer == "ssm":
            return S.make_ssm_cache(cfg, batch, device)
        sub = A.make_cache(cfg, batch, seq, device, dtype)
        if cross_seq:
            return {"self": sub, "cross": A.make_cache(cfg, batch, cross_seq, device, dtype)}
        return sub

    return {f"seg{si}": {f"sub{j}": [one(mixer) for _ in range(n_rep)]
                         for j, (mixer, _) in enumerate(sigs)}
            for si, (n_rep, sigs) in enumerate(segments(cfg))}


def stack_decode(p: Params, cfg, x, cache, position: int, compute_dtype,
                 has_cross: bool = False, ctx=tp.ONE, cache_lens=None):
    """One decode step through all layers; returns (x, cache). The K/V
    buffers are written in place; an SSM layer's entry is replaced. On a
    model group (``ctx``) the params and the cache are the rank's blocks and
    ``cache_lens`` are the self- and cross-attention slots of the whole
    cache (by default the cache's own)."""
    cd, d, eps = compute_dtype, cfg.d_model, cfg.norm_eps
    lay = tp.layout(ctx, 1)
    self_len, cross_len = cache_lens or (None, None)

    def norm(q, h):
        return L.norm_apply(L.norm_whole(q, d, ctx), h, eps, cd)

    for si, (n_rep, sigs) in enumerate(segments(cfg)):
        seg_p, seg_c = p[f"seg{si}"], cache[f"seg{si}"]
        for r in range(n_rep):
            for j, (mixer, mlp_kind) in enumerate(sigs):
                sp, sc = seg_p[f"sub{j}"][r], seg_c[f"sub{j}"][r]
                hn = norm(sp["norm1"], x)
                if mixer == "attn":
                    kv = sc["self"] if has_cross else sc
                    out, _ = A.decode_self_attention(sp["mixer"], cfg, hn, kv, position, cd, ctx,
                                                     self_len)
                    x = x + out
                    if has_cross:
                        hn = norm(sp["norm_cross"], x)
                        x = x + A.decode_cross_attention(sp["cross"], cfg, hn, sc["cross"]["k"],
                                                         sc["cross"]["v"], cd, ctx, cross_len)
                else:
                    out, seg_c[f"sub{j}"][r] = S.ssm_decode_step(sp["mixer"], cfg, hn, sc, cd, ctx)
                    x = x + out
                if mlp_kind != "none":
                    hn = norm(sp["norm2"], x)
                    if mlp_kind == "moe":
                        out = M.moe_block(sp["mlp"], cfg, hn, cd, lay)[0]
                    else:
                        out = L.mlp(sp["mlp"], hn, cfg.act, cd, cfg.d_ff or cfg.moe_d_ff, lay)
                    x = x + out
    return x, cache

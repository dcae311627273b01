"""LM-specific useful-FLOPs accounting (copy of ``repro.roofline.lm``).

MODEL_FLOPS: 6*N*D for training (fwd 2ND + bwd 4ND), 2*N*D for inference
(N = active params for MoE, D = tokens processed globally). The ratio
MODEL_FLOPS / (executed FLOPs * devices) is the "useful fraction": it
exposes recomputation, masked-out attention work and MoE dispatch overhead.

This lives apart from :mod:`repro_torch.roofline.analysis` so the generic
roofline math never reads transformer config fields.
"""

from __future__ import annotations

from typing import Optional


def model_flops(cfg, shape_cfg, dec_tokens: Optional[int] = None) -> float:
    """6*N*D (train) or 2*N*D (inference); N = active params.

    Encoder-decoder models split: encoder params see encoder tokens only,
    decoder (+cross+embedding) params see decoder tokens only.
    """
    _, n_active = cfg.param_counts()
    mult = 6.0 if shape_cfg.kind == "train" else 2.0
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    if shape_cfg.kind in ("train", "prefill"):
        if cfg.is_encdec:
            enc_layer = (cfg._attn_params() + cfg._dense_mlp_params()
                         + 2 * cfg.d_model)
            n_enc = cfg.n_enc_layers * enc_layer + cfg.d_model
            n_dec = n_active - n_enc
            return mult * (n_enc * b * s + n_dec * b * (s // cfg.dec_ratio))
        return mult * n_active * b * s
    # decode: one token per sequence
    tokens = b * (dec_tokens or 1)
    return 2.0 * n_active * tokens

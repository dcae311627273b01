"""InternVL2-1B [arXiv:2404.16821]. InternViT frontend (STUB: input spec
provides 256 precomputed patch embeddings) + Qwen2-0.5B-style LM backbone
(GQA kv=2, QKV bias)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_655,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    n_patches=256,
    source="arXiv:2404.16821",
)

"""Qwen2-7B [arXiv:2407.10671]. Dense, GQA kv=4, QKV bias."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671",
)

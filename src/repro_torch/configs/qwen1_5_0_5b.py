"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B]. Dense, MHA (kv=16), QKV bias."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B",
)

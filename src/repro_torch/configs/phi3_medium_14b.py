"""Phi-3-medium-14B [arXiv:2404.14219]. Dense, RoPE SwiGLU GQA kv=10."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17_920,
    vocab_size=100_352,
    rope_theta=10_000.0,
    source="arXiv:2404.14219",
)

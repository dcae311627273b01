"""Jamba-v0.1-52B [arXiv:2403.19887]. Hybrid Mamba+attention 1:7 interleave
(attention at index 4 of each 8-layer period), MoE 16 experts top-2 on every
second layer."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=65_536,
    rope_theta=10_000.0,
    use_rope=False,       # Jamba attention layers use no positional encoding
    n_experts=16,
    top_k=2,
    moe_d_ff=14_336,
    moe_every=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    source="arXiv:2403.19887",
)

"""OLMoE-1B-7B [arXiv:2409.02060]. MoE: 64 experts, top-8, every layer."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,              # no dense MLP layers
    vocab_size=50_304,
    n_experts=64,
    top_k=8,
    moe_d_ff=1024,
    moe_every=1,
    rope_theta=10_000.0,
    source="arXiv:2409.02060",
)

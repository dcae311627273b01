"""DeepSeekMoE-16B [arXiv:2401.06066]. Fine-grained MoE: 64 routed experts
top-6 + 2 shared experts (d_ff 1408 each); the first layer is a wide dense
FFN (the published model uses d_ff 10944 there)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10_944,         # dense layers (layer 0) use this width
    vocab_size=102_400,
    n_experts=64,
    top_k=6,
    moe_d_ff=1408,
    n_shared_experts=2,
    moe_every=1,
    n_dense_layers=1,
    rope_theta=10_000.0,
    source="arXiv:2401.06066",
)

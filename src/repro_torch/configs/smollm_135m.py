"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M]. Llama-arch small, GQA kv=3."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49_152,
    tie_embeddings=True,
    rope_theta=10_000.0,
    source="hf:HuggingFaceTB/SmolLM-135M",
)

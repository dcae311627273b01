"""Mamba2-780M [arXiv:2405.21060]. Attention-free SSD (state-space duality):
48 layers, d_model 1536 (d_inner 3072, 48 SSM heads of dim 64), state 128."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    d_ff=0,
    vocab_size=50_280,
    tie_embeddings=True,
    ssm_d_state=128,
    ssm_d_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    source="arXiv:2405.21060",
)

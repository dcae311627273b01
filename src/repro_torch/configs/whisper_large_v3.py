"""Whisper-large-v3 backbone [arXiv:2212.04356]. Encoder-decoder, MHA
(kv=20), GELU MLP, LayerNorm. The conv audio frontend is a STUB: the input
spec provides precomputed frame embeddings (B, S, d_model); positions are
sinusoidal on both stacks (Whisper's learned decoder table does not extend
to the assigned 32k/500k frame counts — recorded in DESIGN.md)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,          # decoder layers
    n_enc_layers=32,
    is_encdec=True,
    dec_ratio=8,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    tie_embeddings=True,
    use_rope=False,
    rmsnorm=False,
    act="gelu",
    norm_eps=1e-5,
    source="arXiv:2212.04356",
)

"""LM model substrate (port of ``repro.models``): the dense, MoE, SSM,
hybrid, encoder-decoder and VLM families, the training loss, prefill through
the flash-attention kernel K6 and KV/SSM-cache decode. ``build_model(cfg,
device)`` returns a ``Model``."""

from .api import Model, build_model  # noqa: F401

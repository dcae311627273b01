"""LM model substrate (port of ``repro.models``): the dense decoder-only
family (llama/qwen-style), prefill through the flash-attention kernel K6 and
KV-cache decode. ``build_model(cfg, device)`` returns a ``Model``; the other
families raise ``NotImplementedError`` (ROADMAP A20)."""

from .api import Model, build_model  # noqa: F401

"""Absmax int8 quantisation of halo payloads (port of the two quantisers of
``repro.distributed.compression``).

A payload travels as int8 with one fp32 scale beside it; the receiver
multiplies back. ``compressed_psum_pod``, the training-side all-reduce of
that module, belongs to the LM scaffolding and is not ported here.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)`` with ``q = round(g / scale)`` clipped to [-127, 127]
    and ``scale = max(max|g| / 127, 1e-30)`` (a 0-dim fp32 tensor); rounding
    is half to even, as ``jnp.round``."""
    g32 = g.to(torch.float32)
    scale = torch.clamp(g32.abs().max() / 127.0, min=1e-30)
    q = torch.clamp(torch.round(g32 / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale

"""Device selection for the port's entry points.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU. Asking for the card where there is none raises: nothing carries on
quietly on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but torch sees no CUDA "
                "device; pass device='cpu' for the plain PyTorch path")
        # fp32 products and convolutions in full fp32, never TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {device!r}")
    return dev


def as_tensor(a, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """An array (numpy, or anything ``numpy.asarray`` reads) or a tensor as a
    contiguous tensor on ``device``, cast to ``dtype`` unless it is None."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(device=device, dtype=dtype or a.dtype).contiguous()

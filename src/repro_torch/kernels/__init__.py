"""Hand-written CUDA kernels and their plain PyTorch versions (mirrors
``repro.kernels``)."""

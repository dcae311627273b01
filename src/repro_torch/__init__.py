"""PyTorch/CUDA port of the registration system.

A second package beside the JAX reference ``repro``: the same modules
(``core``, ``kernels``, ``data``) on PyTorch tensors, with every Pallas kernel
of the main path rewritten by hand in CUDA C++ for Hopper (``csrc/``). The
entry point is :func:`repro_torch.core.registration.register`.
"""

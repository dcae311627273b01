"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): one cell a
run, ``python3 -m regbench.run``; see ``regbench/README.md``."""

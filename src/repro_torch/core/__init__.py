"""Solver core of the PyTorch port (mirrors ``repro.core``)."""

"""Roofline math of the port (mirrors ``repro.roofline``): the generic
bounds in ``analysis`` with the H100's peaks, the LM's useful FLOPs in
``lm``. The JAX package's HLO parsers (``hlo``, ``debug``) have no PyTorch
counterpart."""

from .analysis import (  # noqa: F401
    HW, KernelRoofline, RooflineResult, achieved_fraction, kernel_roofline, roofline_terms,
)
from .lm import model_flops  # noqa: F401

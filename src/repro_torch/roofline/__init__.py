"""Roofline math of the port (mirrors ``repro.roofline``): the generic
bounds in ``analysis`` with the H100's peaks, the LM's useful FLOPs in
``lm``, and in place of the JAX package's HLO parsers (``hlo``, ``debug``)
the costs counted as a step runs (``counts``) and their breakdown by
source site (``debug``)."""

from .analysis import (  # noqa: F401
    HBM_BYTES, HW, KernelRoofline, RooflineResult, achieved_fraction, kernel_roofline,
    roofline_terms,
)
from .lm import model_flops  # noqa: F401

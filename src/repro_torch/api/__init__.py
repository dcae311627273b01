"""Public facade of the registration system (port of ``repro.api``).

    from repro_torch import api

    problem = api.RegistrationProblem.synthetic(seed=0, grid=(64, 64, 64))
    result = api.solve(problem, api.SolverOptions(mode="multires"))
    print(result.summary())

Solve strategies (``SolverOptions.mode``):
  single   — Gauss-Newton-Krylov on the full grid (the paper's solver);
  multires — grid continuation: coarse-to-fine pyramid with spectral
             prolongation warm starts;
  batch    — many pairs with per-pair convergence (population studies);
  auto     — batch for batched problems, multires when the grid can coarsen.

Solves run on the card (``SolverOptions.device="cuda"``) unless the options
ask for the CPU; ``mesh`` takes a ``torch.distributed`` slab group or an
ensemble x slab layout (``repro_torch.distributed.group``).
"""

from .options import MODES, SolverOptions
from .problem import RegistrationProblem
from .result import Result
from .solver import Solver, solve

__all__ = [
    "MODES",
    "RegistrationProblem",
    "Result",
    "Solver",
    "SolverOptions",
    "solve",
]

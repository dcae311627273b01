"""The work a registration needs, counted from its shapes and its
algorithm, and the peaks it is divided by.

The counts depend on the grid, ``nt`` and a solve's own counts (gradient
evaluations, Hessian matvecs, line-search evaluations), never on how the
program implements them: each operation reads its inputs once and writes
its outputs once, in fp32. So a fused kernel, a plan-free route or a new
kernel cannot make a share read above 100%.

Per point of an N1 x N2 x N3 grid (n points, 4-byte floats):

- interpolation pass of ``k`` fields at one point set (the paper's model,
  its 20 B/point at k = 1): the query's three coordinates read, each field
  read and its value written: (12 + 8k) bytes; 131 + 128k operations (the
  B-spline weights and their 80 tensor products once, then a multiply-add
  per tap and field);
- prefilter of a field (the separable 15-tap filter as one 3D operation):
  8 bytes, 3 x 23 operations;
- FD8: the gradient of a scalar 4 + 12 bytes, the divergence of a vector
  12 + 4 bytes, det(I + grad u) of the deformation 12 + 4 bytes; 13
  operations per derivative;
- spectral operator on a vector field (three forward and three inverse real
  FFTs): 6 x 8 bytes, 6 x 2.5 log2(n) operations.

Pointwise work (RK2 updates, products with grad m, PCG vector updates,
inner products) is not counted: the counts are a lower bound.

Per gradient evaluation: the forward and backward characteristic traces
(two passes of 3 fields), the state (nt passes of 1 field) and the adjoint
(nt passes of 2 fields); the prefilter of v and of every advected field;
div v and grad m at nt + 1 times; A v and the first preconditioner
application. Per Hessian matvec: the incremental state and adjoint (2nt
passes of 2 fields, their prefilters), A vt and one preconditioner
application. Per line-search evaluation: a trace (3 fields) and the state
(nt passes), their prefilters, and A v for the regularisation energy. Per
registration: det F's deformation composed over nt - 1 passes of 3 fields
(the first step interpolates zero), their prefilters and det(I + grad u);
the warped image and the mismatch are the last evaluation's state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

#: NVIDIA H100 SXM5 data sheet (dense, 700 W): fp32 without the tensor cores
PEAK_FP32_FLOPS = 67e12
#: NVIDIA H100 SXM5 data sheet: HBM3 bandwidth
PEAK_HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass
class Work:
    bytes: float = 0.0
    flops: float = 0.0
    passes: int = 0        # operations (interpolation passes, stencil ops, FFT ops)
    fields: int = 0        # fields those operations produce

    def __add__(self, o: "Work") -> "Work":
        return Work(self.bytes + o.bytes, self.flops + o.flops, self.passes + o.passes,
                    self.fields + o.fields)

    def __mul__(self, k: float) -> "Work":
        return Work(self.bytes * k, self.flops * k, int(self.passes * k), int(self.fields * k))

    def bound_s(self) -> float:
        """The least time on the chip: the larger of bytes over the memory
        bandwidth and operations over the fp32 rate."""
        return max(self.bytes / PEAK_HBM_BYTES_PER_S, self.flops / PEAK_FP32_FLOPS)


KINDS = ("interp", "prefilter", "fd8", "fft")


def _interp(n: int, k: int, passes: int = 1) -> Work:
    return Work((12 + 8 * k) * n * passes, (131 + 128 * k) * n * passes, passes, k * passes)


def _prefilter(n: int, fields: int) -> Work:
    return Work(8 * n * fields, 69 * n * fields, fields, fields)


def _fd8(n: int, read: int, write: int, derivatives: int) -> Work:
    return Work(4 * (read + write) * n, 13 * derivatives * n, 1, write)


def _fft(n: int, ops: int) -> Work:
    return Work(48 * n * ops, 15 * math.log2(n) * n * ops, ops, 3 * ops)


def _zero() -> Dict[str, Work]:
    return {k: Work() for k in KINDS}


def gradient(n: int, nt: int) -> Dict[str, Work]:
    w = _zero()
    w["interp"] = _interp(n, 3, 2) + _interp(n, 1, nt) + _interp(n, 2, nt)
    w["prefilter"] = _prefilter(n, 3 + nt + 2 * nt)
    w["fd8"] = _fd8(n, 3, 1, 3) + _fd8(n, 1, 3, 3) * (nt + 1)
    w["fft"] = _fft(n, 2)
    return w


def matvec(n: int, nt: int) -> Dict[str, Work]:
    w = _zero()
    w["interp"] = _interp(n, 2, 2 * nt)
    w["prefilter"] = _prefilter(n, 4 * nt)
    w["fft"] = _fft(n, 2)
    return w


def line_search(n: int, nt: int) -> Dict[str, Work]:
    w = _zero()
    w["interp"] = _interp(n, 3) + _interp(n, 1, nt)
    w["prefilter"] = _prefilter(n, 3 + nt)
    w["fft"] = _fft(n, 1)
    return w


def scoring(n: int, nt: int) -> Dict[str, Work]:
    w = _zero()
    w["interp"] = _interp(n, 3, nt - 1)
    w["prefilter"] = _prefilter(n, 3 * (nt - 1))
    w["fd8"] = _fd8(n, 3, 1, 9)
    return w


def registration(grid, nt: int, evaluations: int, matvecs: int,
                 ls_evals: int) -> Dict[str, Work]:
    """The counted work of one registration by kind, at its own counts:
    ``evaluations`` gradients (one per Newton step taken, the last one's
    included), ``matvecs`` Hessian matvecs and ``ls_evals`` objective
    evaluations of the line searches."""
    n = math.prod(int(x) for x in grid)
    parts = [(gradient(n, nt), evaluations), (matvec(n, nt), matvecs),
             (line_search(n, nt), ls_evals), (scoring(n, nt), 1)]
    out = _zero()
    for w, times in parts:
        for k in KINDS:
            out[k] = out[k] + w[k] * times
    return out


def total(work: Dict[str, Work]) -> Work:
    out = Work()
    for w in work.values():
        out = out + w
    return out

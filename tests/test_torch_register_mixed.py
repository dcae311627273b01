"""Port parity, mixed precision as a whole: ``register(mixed_precision=True)``
(bf16 interpolation weights, fp32 data and accumulation) of the 16^3
synthetic pair of ``repro.data.synthetic.make_pair`` (seed 0, fd8-cubic,
handed over as numpy) against the JAX package's mixed-precision ``register``.

bf16 weights round where XLA's fusion decides (``kernels/interp3d.py``), so
the bound is the solver's, not the kernels': Newton iterations within +-1,
|d mismatch_rel| <= 1e-2, det F min > 0. Against the port's own fp32 solve,
|d mismatch_rel| < 0.08 (``tests/test_gauss_newton.py``'s bf16-vs-fp32
bound). The port runs the plan-path and the fused matvec, and the plan-free
path, each with bf16 weights.
"""

import jax
import numpy as np
import pytest

from repro.core import registration as jR
from repro.data import synthetic as jsyn
from repro_torch.core import registration as tR

SHAPE = (16, 16, 16)


@pytest.fixture(scope="module")
def pair_and_ref():
    pair = jsyn.make_pair(jax.random.PRNGKey(0), SHAPE)
    m0, m1 = np.asarray(pair.m0), np.asarray(pair.m1)
    ref = jR.register(pair.m0, pair.m1, mixed_precision=True)
    fp32 = tR.register(m0, m1, device="cpu")
    return m0, m1, ref, fp32


@pytest.mark.parametrize("kw", [dict(), dict(use_fused_matvec=True),
                                dict(use_plan=False)],
                         ids=["plan_matvec", "fused_matvec", "plan_free"])
def test_mixed_precision_register_matches_jax(pair_and_ref, kw):
    m0, m1, ref, fp32 = pair_and_ref
    got = tR.register(m0, m1, mixed_precision=True, device="cpu", **kw)
    # The counts, for the record (pytest -s shows them).
    print(f"\nmixed {kw}: port iters {got.iters} pcg "
          f"{[h['pcg_iters'] for h in got.history]} mismatch {got.mismatch_rel:.6f}; "
          f"JAX iters {ref.iters} pcg {[h['pcg_iters'] for h in ref.history]} "
          f"mismatch {ref.mismatch_rel:.6f}; port fp32 iters {fp32.iters} "
          f"mismatch {fp32.mismatch_rel:.6f}")
    assert abs(got.iters - ref.iters) <= 1
    assert abs(got.mismatch_rel - ref.mismatch_rel) <= 1e-2
    assert got.detF["min"] > 0 and ref.detF["min"] > 0
    assert abs(got.mismatch_rel - fp32.mismatch_rel) < 0.08
    assert bool(np.isfinite(got.v.numpy()).all())

"""Port parity, the plan-free slice as a whole: ``register(use_plan=False)``
of the 16^3 synthetic pair of ``repro.data.synthetic.make_pair`` (seed 0,
fd8-cubic, handed over as numpy) against the JAX package's
``register(use_plan=False)``.

Every semi-Lagrangian step interpolates at its footpoints (kernel K4's plain
version here) and every matvec recomputes the trajectory gradients. Newton
iterations, the PCG count and line-search evaluations of every step must be
equal; the velocity within 1e-4 * max|v|, the relative mismatch within 1e-4
relative and det F within 1e-4, as ``tests/test_torch_register.py``.
"""

import jax
import numpy as np

from repro.core import registration as jR
from repro.data import synthetic as jsyn
from repro_torch.core import registration as tR

SHAPE = (16, 16, 16)


def test_register_without_plans_matches_jax():
    pair = jsyn.make_pair(jax.random.PRNGKey(0), SHAPE)
    ref = jR.register(pair.m0, pair.m1, use_plan=False)
    got = tR.register(np.asarray(pair.m0), np.asarray(pair.m1), use_plan=False,
                      device="cpu")
    assert got.iters == ref.iters
    for key in ("pcg_iters", "ls_evals"):
        assert [h[key] for h in got.history] == [h[key] for h in ref.history], key
    assert got.matvecs == ref.matvecs and got.converged == ref.converged
    v = np.asarray(ref.v)
    dv = float(np.max(np.abs(got.v.numpy() - v)))
    assert dv <= 1e-4 * float(np.max(np.abs(v))), dv
    np.testing.assert_allclose(got.mismatch_rel, ref.mismatch_rel, rtol=1e-4)
    for key in ("min", "mean", "max"):
        np.testing.assert_allclose(got.detF[key], ref.detF[key], atol=1e-4)

"""Port parity, the slice as a whole: ``repro_torch`` registers the 16^3
synthetic pair of ``repro.data.synthetic.make_pair`` (seed 0, fd8-cubic,
handed over as numpy) as the JAX package's ``register`` does.

Newton iterations, the PCG count of every step and ``converged`` must be
equal. The velocity must agree within 1e-4 * max|v| (observed: 5e-6
relative), the relative mismatch within 1e-4 relative and the det F
statistics within 1e-4. The port runs with both matvec paths; JAX runs its
default (plan-path) matvec.
"""

import jax
import numpy as np
import pytest

from repro.core import registration as jR
from repro.data import synthetic as jsyn
from repro_torch.core import registration as tR

SHAPE = (16, 16, 16)


@pytest.fixture(scope="module")
def jax_result():
    pair = jsyn.make_pair(jax.random.PRNGKey(0), SHAPE)
    res = jR.register(pair.m0, pair.m1)
    return dict(m0=np.asarray(pair.m0), m1=np.asarray(pair.m1), res=res,
                v=np.asarray(res.v))


@pytest.mark.parametrize("fused", [False, True], ids=["plan_matvec", "fused_matvec"])
def test_register_matches_jax(jax_result, fused):
    ref = jax_result["res"]
    got = tR.register(jax_result["m0"], jax_result["m1"], use_fused_matvec=fused,
                      device="cpu")
    assert got.iters == ref.iters
    assert [h["pcg_iters"] for h in got.history] == [h["pcg_iters"] for h in ref.history]
    assert [h["ls_evals"] for h in got.history] == [h["ls_evals"] for h in ref.history]
    assert got.matvecs == ref.matvecs
    assert got.converged == ref.converged
    v = jax_result["v"]
    dv = float(np.max(np.abs(got.v.numpy() - v)))
    assert dv <= 1e-4 * float(np.max(np.abs(v))), dv
    np.testing.assert_allclose(got.mismatch_rel, ref.mismatch_rel, rtol=1e-4)
    for key in ("min", "mean", "max"):
        np.testing.assert_allclose(got.detF[key], ref.detF[key], atol=1e-4)
    assert got.m_warped.shape == SHAPE
    np.testing.assert_allclose(got.rel_grad, ref.rel_grad, rtol=1e-3)

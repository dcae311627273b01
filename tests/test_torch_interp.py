"""Port parity, interpolation plans + kernels K2 and K3: ``build_plan``,
the plain versions of the plan gather (K2) and of the fused gather + matvec
epilogue (K3), against the JAX package on the same numpy inputs.

JAX's plan kernels run in Pallas interpret mode, as ``tests/test_plan.py``
and ``tests/test_fused_matvec.py`` run them. Plan indices must be equal
(atol 0), weights within 1e-6, K2 within ``test_plan.py``'s 1e-6 and K3
within ``test_fused_matvec.py``'s 1e-5 * max(scale, 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grid as jG
from repro.core import interp as jI
from repro.kernels.interp3d import interp3d as jK
from repro.kernels.interp3d import ops as jops
from repro_torch.core import interp as tI
from repro_torch.kernels import interp3d as tK

SHAPE = (16, 12, 8)
DT = 0.25


def _rand(shape, seed, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is None:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _queries(shape, seed, spread=3.0, offset=0.0):
    return (np.asarray(jG.index_coords(shape)) + offset
            + _rand((3,) + shape, seed, -spread, spread)).astype(np.float32)


def _plans(q, method):
    return (tI.build_plan(torch.from_numpy(q), method=method),
            jI.build_plan(jnp.asarray(q), method=method))


@pytest.mark.parametrize("method", tI.METHODS)
@pytest.mark.parametrize("offset", [0.0, -3.0])
def test_build_plan_matches_jax(method, offset):
    """Equal indices (floor + floor-mod wrap, also for footpoints below the
    low edge) and weights within 1e-6."""
    q = _queries(SHAPE, 1, offset=offset)
    tp, jp = _plans(q, method)
    assert tp.support == jp.support and tp.field_shape == jp.field_shape
    assert tp.out_shape == tuple(jp.out_shape)
    for ti, ji in zip(tp.idx, jp.idx):
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for tw, jw in zip(tp.weights, jp.weights):
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", tI.METHODS)
def test_apply_plan_plain_matches_jax_and_pallas(method):
    q = _queries(SHAPE, 2)
    f = _rand(SHAPE, 3)
    tp, jp = _plans(q, method)
    got = tK.apply_plan_plain(torch.from_numpy(f), tp).numpy()
    np.testing.assert_allclose(got, np.asarray(jI.apply_plan(jp, jnp.asarray(f))), atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jops.interp_apply_plan(jnp.asarray(f), jp)),
                               atol=1e-6)


def test_apply_plan_batched_matches_jax_and_per_field():
    q = _queries(SHAPE, 4)
    w = _rand((3,) + SHAPE, 5)
    tp, jp = _plans(q, "cubic_bspline")
    got = tI.apply_plan(tp, torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jops.interp_apply_plan_batched(jnp.asarray(w), jp)), atol=1e-6)
    for k in range(3):
        np.testing.assert_array_equal(got[k], tI.apply_plan(tp, torch.from_numpy(w[k])).numpy())


_JAX_EPILOGUES = {
    "inc_state": lambda accs, extras: accs[0] + 0.5 * DT * (accs[1] + extras[0]),
    "inc_adjoint": lambda accs, extras: accs[0] + 0.5 * DT * (
        accs[1] + extras[0] * (accs[0] + DT * accs[1])),
}


@pytest.mark.parametrize("epilogue", sorted(_JAX_EPILOGUES))
@pytest.mark.parametrize("method", ["cubic_bspline", "linear"])
def test_apply_plan_fused_plain_matches_jax(epilogue, method):
    q = _queries(SHAPE, 6)
    coefs = _rand((2,) + SHAPE, 7)
    extra = _rand(SHAPE, 8)
    tp, jp = _plans(q, method)
    got = tK.apply_plan_fused_plain(torch.from_numpy(coefs), tp, torch.from_numpy(extra),
                                    epilogue, DT).numpy()
    ref = np.asarray(jK.apply_plan_fused(jnp.asarray(coefs), jp, [jnp.asarray(extra)],
                                         _JAX_EPILOGUES[epilogue]))
    scale = float(np.max(np.abs(ref)))
    assert float(np.max(np.abs(got - ref))) <= 1e-5 * max(scale, 1.0)
    # the dispatching wrapper takes the same plain version on the CPU
    np.testing.assert_array_equal(
        tK.apply_plan_fused(torch.from_numpy(coefs), tp, torch.from_numpy(extra),
                            epilogue, DT).numpy(), got)


def test_interp_vector_matches_jax():
    q = _queries(SHAPE, 9, spread=2.0)
    w = _rand((3,) + SHAPE, 10)
    got = tI.interp_vector(torch.from_numpy(w), torch.from_numpy(q)).numpy()
    ref = np.asarray(jI.interp_vector(jnp.asarray(w), jnp.asarray(q)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_wrappers_check_shapes():
    q = _queries(SHAPE, 11)
    tp, _ = _plans(q, "cubic_bspline")
    with pytest.raises(ValueError, match="plan field shape"):
        tK.apply_plan(torch.zeros((8, 8, 8)), tp)
    with pytest.raises(ValueError, match="2, N1, N2, N3"):
        tK.apply_plan_fused(torch.zeros((3,) + SHAPE), tp, torch.zeros(SHAPE),
                            "inc_state", DT)
    with pytest.raises(ValueError, match="unknown epilogue"):
        tK.apply_plan_fused(torch.zeros((2,) + SHAPE), tp, torch.zeros(SHAPE), "x", DT)
    with pytest.raises(ValueError, match="extra field shape"):
        tK.apply_plan_fused(torch.zeros((2,) + SHAPE), tp, torch.zeros((8, 8, 8)),
                            "inc_state", DT)

"""Port parity, plan-free interpolation (kernel K4) and bf16-weight plans
(K2/K3 mixed precision), against the JAX package on the same numpy inputs.

Tolerances:
- K4's plain version against ``interp3d_pallas`` in Pallas interpret mode
  (as ``tests/test_kernels.py`` runs it), queries inside the displacement
  bound: rtol 1e-4 / atol 1e-4 with fp32 weights; with bf16 weights
  max|port - pallas| / max|pallas| < 2e-2 (``test_kernels.py``'s bf16 bound;
  the Pallas kernel rounds its weights in another frame).
- K4's plain version against jitted ``interp_field``, fp32 and bf16 weights,
  also for queries shifted past the bound: <= 1e-5 * max(|ref|, 1).
- ``build_plan(weight_dtype=bf16)``: indices equal, weights bit-equal to
  JAX's jitted ``build_plan`` cast to fp32. Plain K2 / K3 with bf16 weights
  against jitted ``apply_plan`` / ``apply_plan_fused``: <= 1e-5 * max(|ref|, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grid as jG
from repro.core import interp as jI
from repro.kernels.interp3d import interp3d as jK
from repro_torch import interop
from repro_torch.core import interp as tI
from repro_torch.core import semilag as tSL
from repro_torch.kernels import counts
from repro_torch.kernels import interp3d as tK

SHAPES = [(16, 12, 8), (24, 16, 32)]
SHAPE = SHAPES[0]
DT = 0.25
BF16 = {None: None, "bf16": torch.bfloat16}
J_BF16 = {None: None, "bf16": jnp.bfloat16}


def _rand(shape, seed, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is None:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _queries(shape, seed, spread=3.0, offset=0.0):
    return (np.asarray(jG.index_coords(shape)) + offset
            + _rand((3,) + shape, seed, -spread, spread)).astype(np.float32)


def _within_scaled(got, ref, rel=1e-5):
    ref = np.asarray(ref, np.float32)
    dev = float(np.max(np.abs(np.asarray(got) - ref)))
    assert dev <= rel * max(float(np.max(np.abs(ref))), 1.0), dev


@pytest.mark.parametrize("basis", tI.METHODS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k4_plain_matches_pallas(shape, basis):
    """Queries within 2.5 voxels of their grid point, bound 3 (as
    ``test_kernels.py``): the halo tile holds every tap."""
    f = _rand(shape, 7)
    q = _queries(shape, 8, spread=2.5)
    ref = jK.interp3d_pallas(jnp.asarray(f), jnp.asarray(q), basis=basis,
                             displacement_bound=3)
    got = tK.interp3d_plain(torch.from_numpy(f), torch.from_numpy(q), basis)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("basis", tI.METHODS)
def test_k4_plain_bf16_matches_pallas(basis):
    f = _rand(SHAPE, 12)
    q = _queries(SHAPE, 13, spread=2.0)
    ref = np.asarray(jK.interp3d_pallas(
        jnp.asarray(f), jnp.asarray(q), basis=basis,
        displacement_bound=tSL.DISPLACEMENT_BOUND, weight_dtype=jnp.bfloat16))
    got = tK.interp3d_plain(torch.from_numpy(f), torch.from_numpy(q), basis,
                            torch.bfloat16).numpy()
    assert float(np.max(np.abs(got - ref)) / np.max(np.abs(ref))) < 2e-2


@pytest.mark.parametrize("weights", [None, "bf16"])
@pytest.mark.parametrize("basis", tI.METHODS)
@pytest.mark.parametrize("offset", [0.0, -3.0, -9.5], ids=["inside", "shift-3",
                                                           "past-bound"])
def test_k4_plain_matches_jitted_interp_field(offset, basis, weights):
    """The solver's plan-free step is jitted ``interp_field``; K4's plain
    version follows its arithmetic, bf16 weight rounding included, for any
    query (the wrap is global: -9.5 is past the Pallas bound of 6)."""
    shape = SHAPES[1]
    f = _rand(shape, 1)
    q = _queries(shape, 2, offset=offset)
    ref = jax.jit(lambda f_, q_: jI.interp_field(
        f_, q_, basis, prefiltered=True, weight_dtype=J_BF16[weights]))(f, q)
    got = tI.interp_field(torch.from_numpy(f), torch.from_numpy(q), basis,
                          prefiltered=True, weight_dtype=BF16[weights])
    _within_scaled(got.numpy(), ref)


def test_k4_fields_share_queries_and_cpu_takes_plain():
    f = _rand((2,) + SHAPE, 3)
    q = torch.from_numpy(_queries(SHAPE, 4, offset=-3.0))
    counts.reset()
    both = tK.interp3d(torch.from_numpy(f), q, "cubic_bspline", torch.bfloat16)
    assert counts.snapshot() == {"plain:interp3d:cubic_bspline:bf16": 1}
    assert both.shape == (2,) + SHAPE and both.dtype == torch.float32
    for k in range(2):
        np.testing.assert_array_equal(
            both[k].numpy(),
            tK.interp3d_plain(torch.from_numpy(f[k]), q, "cubic_bspline",
                              torch.bfloat16).numpy())
    # queries on another grid than the field: out shape follows q
    q_small = torch.from_numpy(_queries((4, 6, 5), 5))
    assert tK.interp3d(torch.from_numpy(f), q_small, "linear").shape == (2, 4, 6, 5)
    with pytest.raises(ValueError, match="unknown basis"):
        tK.interp3d(torch.from_numpy(f), q, "cubic")
    with pytest.raises(ValueError, match="query points"):
        tK.interp3d(torch.from_numpy(f), q[:2], "linear")


@pytest.mark.parametrize("prefilter", ["fir", "fft"])
def test_interp_cubic_bspline_prefilters_match_jax(prefilter):
    f = _rand(SHAPE, 6)
    q = _queries(SHAPE, 7, spread=2.0)
    ref = jI.interp_cubic_bspline(jnp.asarray(f), jnp.asarray(q), prefilter=prefilter)
    got = tI.interp_cubic_bspline(torch.from_numpy(f), torch.from_numpy(q),
                                  prefilter=prefilter)
    _within_scaled(got.numpy(), ref)
    np.testing.assert_allclose(tI.prefilter_fft(torch.from_numpy(f)).numpy(),
                               np.asarray(jI.prefilter_fft(jnp.asarray(f))),
                               rtol=1e-5, atol=1e-5)


def _plans(q, method, weight_dtype):
    jp = jax.jit(lambda q_: jI.build_plan(q_, method=method, weight_dtype=weight_dtype))(q)
    tp = tI.build_plan(torch.from_numpy(q), method, torch.bfloat16)
    return tp, jp


@pytest.mark.parametrize("method", tI.METHODS)
def test_build_plan_bf16_matches_jax(method):
    q = _queries(SHAPES[1], 9, offset=-3.0)
    tp, jp = _plans(q, method, jnp.bfloat16)
    for ti, ji in zip(tp.idx, jp.idx):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for tw, jw in zip(tp.weights, jp.weights):
        assert tw.dtype == torch.bfloat16
        np.testing.assert_array_equal(tw.float().numpy(), np.asarray(jw, np.float32))


@pytest.mark.parametrize("method", tI.METHODS)
def test_apply_plan_bf16_plain_matches_jax(method):
    q = _queries(SHAPE, 10)
    tp, jp = _plans(q, method, jnp.bfloat16)
    for lead in ((), (3,)):
        f = _rand(lead + SHAPE, 11)
        ref = jax.jit(jI.apply_plan)(jp, f)
        _within_scaled(tK.apply_plan_plain(torch.from_numpy(f), tp).numpy(), ref)


_JAX_EPILOGUES = {
    "inc_state": lambda accs, extras: accs[0] + 0.5 * DT * (accs[1] + extras[0]),
    "inc_adjoint": lambda accs, extras: accs[0] + 0.5 * DT * (
        accs[1] + extras[0] * (accs[0] + DT * accs[1])),
}


@pytest.mark.parametrize("epilogue", sorted(_JAX_EPILOGUES))
@pytest.mark.parametrize("method", ["cubic_bspline", "linear"])
def test_apply_plan_fused_bf16_plain_matches_jax(method, epilogue):
    q = _queries(SHAPE, 12)
    tp, jp = _plans(q, method, jnp.bfloat16)
    coefs, extra = _rand((2,) + SHAPE, 13), _rand(SHAPE, 14)
    ref = jax.jit(lambda c, p, e: jK.apply_plan_fused(
        c, p, [e], _JAX_EPILOGUES[epilogue]))(coefs, jp, extra)
    got = tK.apply_plan_fused_plain(torch.from_numpy(coefs), tp, torch.from_numpy(extra),
                                    epilogue, DT)
    _within_scaled(got.numpy(), ref)


def test_interp_vector_bf16_matches_jax():
    q = _queries(SHAPE, 15, spread=2.0)
    w = _rand((3,) + SHAPE, 16)
    ref = jax.jit(lambda w_, q_: jI.interp_vector(w_, q_, weight_dtype=jnp.bfloat16))(w, q)
    got = tI.interp_vector(torch.from_numpy(w), torch.from_numpy(q),
                           weight_dtype=torch.bfloat16)
    _within_scaled(got.numpy(), ref)


def test_interop_carries_a_bf16_plan():
    """A JAX bf16 plan read across (as float32, then cast back) is the same
    plan: applied by the port it gives JAX's result."""
    q = _queries(SHAPE, 17, offset=-3.0)
    jp = jax.jit(lambda q_: jI.build_plan(q_, "cubic_bspline",
                                          weight_dtype=jnp.bfloat16))(q)
    tp = interop.plan_from_numpy(jp.idx, jp.weights, jp.method, jp.field_shape,
                                 device="cpu")
    assert all(w.dtype == torch.bfloat16 for w in tp.weights)
    f = _rand((2,) + SHAPE, 18)
    _within_scaled(tI.apply_plan(tp, torch.from_numpy(f)).numpy(),
                   jax.jit(jI.apply_plan)(jp, f))

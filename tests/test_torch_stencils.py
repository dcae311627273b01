"""Port parity, grid + kernel K1: the plain version of the periodic stencil
kernel (FD8 derivatives, B-spline prefilter) and the grid and spectral
derivative helpers against the JAX package on the same numpy inputs.

JAX's Pallas kernels run as ``tests/test_kernels.py`` runs them on the CPU
(interpret mode). Tolerances are ``test_kernels.py``'s fp32 ones: rtol 1e-5,
atol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import derivatives as jD
from repro.core import grid as jG
from repro.core import interp as jI
from repro.kernels.fd8 import ops as fd8_ops
from repro.kernels.prefilter import ops as pf_ops
from repro_torch.core import derivatives as tD
from repro_torch.core import grid as tG
from repro_torch.core import interp as tI
from repro_torch.kernels import fd8 as tFD8
from repro_torch.kernels import prefilter as tPF

SHAPES = [(8, 8, 8), (16, 12, 8), (24, 16, 32), (9, 16, 8), (8, 10, 12)]
TOL = dict(rtol=1e-5, atol=1e-4)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fd8_partial_matches_pallas(shape, axis):
    f = _rand(shape, 0)
    np.testing.assert_allclose(tFD8.fd8_partial(_t(f), axis).numpy(),
                               np.asarray(fd8_ops.fd8_partial(jnp.asarray(f), axis)),
                               **TOL)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_fd8_grad_div_match_pallas(shape):
    f = _rand(shape, 1)
    w = _rand((3,) + shape, 2)
    np.testing.assert_allclose(tFD8.fd8_grad(_t(f)).numpy(),
                               np.asarray(fd8_ops.fd8_grad(jnp.asarray(f))), **TOL)
    np.testing.assert_allclose(tFD8.fd8_div(_t(w)).numpy(),
                               np.asarray(fd8_ops.fd8_div(jnp.asarray(w))), **TOL)
    # the solver's dispatch (jnp roll path in JAX) agrees as well
    np.testing.assert_allclose(tD.grad(_t(f), "fd8").numpy(),
                               np.asarray(jD.grad(jnp.asarray(f), "fd8")), **TOL)
    np.testing.assert_allclose(tD.div(_t(w), "fd8").numpy(),
                               np.asarray(jD.div(jnp.asarray(w), "fd8")), **TOL)


def test_fd8_grad_of_a_stack_is_per_field():
    fs = _rand((3, 8, 10, 12), 3)
    batched = tFD8.fd8_grad(_t(fs)).numpy()
    assert batched.shape == (3, 3, 8, 10, 12)
    for k in range(3):
        np.testing.assert_array_equal(batched[k], tFD8.fd8_grad(_t(fs[k])).numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_prefilter_matches_pallas(shape):
    f = _rand(shape, 5)
    np.testing.assert_allclose(tPF.prefilter3d(_t(f)).numpy(),
                               np.asarray(pf_ops.prefilter3d(jnp.asarray(f))), **TOL)


def test_prefilter_stack_matches_core_fir():
    """The batched prefilter (K1 over a K=3 stack) against JAX's batched
    ``prefilter_fir`` and against per-field filtering."""
    fs = _rand((3, 16, 12, 8), 6)
    got = tI.prefilter_fir(_t(fs)).numpy()
    np.testing.assert_allclose(got, np.asarray(jI.prefilter_fir(jnp.asarray(fs))), **TOL)
    for k in range(3):
        np.testing.assert_array_equal(got[k], tI.prefilter_fir(_t(fs[k])).numpy())
    np.testing.assert_allclose(np.asarray(tI.PREFILTER_TAPS), np.asarray(jI.PREFILTER_TAPS),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(12, 16, 8), (9, 16, 8)])
def test_spectral_derivatives_match_jax(shape):
    f = _rand(shape, 7)
    w = _rand((3,) + shape, 8)
    for a in range(3):
        np.testing.assert_allclose(tD.spectral_partial(_t(f), a).numpy(),
                                   np.asarray(jD.spectral_partial(jnp.asarray(f), a)),
                                   **TOL)
    np.testing.assert_allclose(tD.grad(_t(f), "fft").numpy(),
                               np.asarray(jD.grad(jnp.asarray(f), "fft")), **TOL)
    np.testing.assert_allclose(tD.div(_t(w), "fft").numpy(),
                               np.asarray(jD.div(jnp.asarray(w), "fft")), **TOL)


@pytest.mark.parametrize("shape", [(8, 8, 8), (12, 16, 9)])
def test_grid_helpers_match_jax(shape):
    assert tG.spacing(shape) == jG.spacing(shape)
    assert tG.cell_volume(shape) == jG.cell_volume(shape)
    np.testing.assert_array_equal(tG.coords(shape).numpy(), np.asarray(jG.coords(shape)))
    np.testing.assert_array_equal(tG.index_coords(shape).numpy(),
                                  np.asarray(jG.index_coords(shape)))
    for rfft in (True, False):
        for tk, jk in zip(tG.wavenumbers(shape, rfft=rfft), jG.wavenumbers(shape, rfft=rfft)):
            np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        for tm, jm in zip(tG.zero_nyquist_mask(shape, rfft=rfft),
                          jG.zero_nyquist_mask(shape, rfft=rfft)):
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # fp32 sums of a few thousand random products with cancellation differ
    # by summation order: 1e-4 relative.
    a, b = _rand((3,) + shape, 9), _rand((3,) + shape, 10)
    np.testing.assert_allclose(float(tG.inner(_t(a), _t(b))),
                               float(jG.inner(jnp.asarray(a), jnp.asarray(b))), rtol=1e-4)
    np.testing.assert_allclose(float(tG.norm_l2(_t(a))),
                               float(jG.norm_l2(jnp.asarray(a))), rtol=1e-5)
    assert tG.inner(_t(a), _t(b)).dtype == torch.float32

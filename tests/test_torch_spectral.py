"""Port parity, spectral operators (A, A^-1, Leray, energy, smoothing) against
the JAX package on the same numpy inputs, plus the operator properties that
``tests/test_spectral.py`` holds the JAX operators to, at its tolerances.

Between the two packages the operators are the same FFT arithmetic in
another library (pocketfft in both on the CPU, in another order of the
batched axes); fields are compared relative to their maximum at 2e-5, the
tolerance ``test_spectral.py`` gives Leray's idempotence.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch

from repro.core import spectral as jS
from repro_torch.core import derivatives as tD
from repro_torch.core import grid as tG
from repro_torch.core import spectral as tS

SHAPE = (12, 16, 8)
REL = 2e-5


def _zero_mean_vec(seed, shape=SHAPE):
    v = np.random.default_rng(seed).standard_normal((3,) + shape).astype(np.float32)
    return v - v.mean(axis=(1, 2, 3), keepdims=True)


def _close(got, ref):
    ref = np.asarray(ref)
    scale = float(np.max(np.abs(ref))) + 1e-6
    np.testing.assert_allclose(np.asarray(got) / scale, ref / scale, atol=REL)


@pytest.mark.parametrize("beta,gamma", [(5e-4, 1e-4), (1e-2, 0.0), (1e-4, 1e-1)])
def test_regop_and_inverse_match_jax(beta, gamma):
    v = _zero_mean_vec(1)
    tv, jv = torch.from_numpy(v), jnp.asarray(v)
    _close(tS.apply_regop(tv, beta, gamma).numpy(), jS.apply_regop(jv, beta, gamma))
    for zmi in (True, False):
        _close(tS.apply_inv_regop(tv, beta, gamma, zero_mean_identity=zmi).numpy(),
               jS.apply_inv_regop(jv, beta, gamma, zero_mean_identity=zmi))
    np.testing.assert_allclose(float(tS.reg_energy(tv, beta, gamma)),
                               float(jS.reg_energy(jv, beta, gamma)), rtol=1e-5)


@pytest.mark.parametrize("shape", [SHAPE, (9, 10, 11)])
def test_leray_and_gauss_smooth_match_jax(shape):
    v = _zero_mean_vec(2, shape)
    _close(tS.leray_project(torch.from_numpy(v)).numpy(), jS.leray_project(jnp.asarray(v)))
    _close(tS.gauss_smooth(torch.from_numpy(v), 2.0).numpy(),
           jS.gauss_smooth(jnp.asarray(v), 2.0))
    _close(tS.gauss_smooth(torch.from_numpy(v[0]), 1.5).numpy(),
           jS.gauss_smooth(jnp.asarray(v[0]), 1.5))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inv_regop_is_right_inverse(seed):
    v = torch.from_numpy(_zero_mean_vec(seed))
    w = tS.apply_regop(tS.apply_inv_regop(v, 5e-4, 1e-4), 5e-4, 1e-4)
    scale = float(v.abs().max()) + 1e-6
    np.testing.assert_allclose((w / scale).numpy(), (v / scale).numpy(), atol=5e-3)


def test_leray_idempotent_divfree_and_regop_symmetric():
    v = torch.from_numpy(_zero_mean_vec(3))
    u = torch.from_numpy(_zero_mean_vec(4))
    pv = tS.leray_project(v)
    scale = float(v.abs().max()) + 1e-6
    np.testing.assert_allclose((tS.leray_project(pv) / scale).numpy(),
                               (pv / scale).numpy(), atol=2e-5)
    assert float(tD.spectral_div(pv).abs().max()) < 5e-3 * scale
    lhs = float(tG.inner(tS.apply_regop(u, 5e-4, 1e-4), v))
    rhs = float(tG.inner(u, tS.apply_regop(v, 5e-4, 1e-4)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4, atol=1e-6)
    assert float(tG.inner(tS.apply_regop(v, 5e-4, 1e-4), v)) > 0.0

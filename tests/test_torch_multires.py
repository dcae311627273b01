"""Port parity, multires transfers: ``fourier_resample``, ``restrict``,
``prolong`` and ``default_level_shapes`` against the JAX package on the same
numpy inputs (as ``tests/test_multires.py``), at 1e-6; and the port's own
transfer algebra at ``test_multires.py``'s bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grid as jG
from repro.core import multires as jMR
from repro.data import synthetic as jsyn
from repro_torch.core import multires as tMR
from repro_torch.core import transport as tT


def _band_limited(shape, kmax=3):
    x = jG.coords(shape)
    return np.array(jnp.sin(x[0]) * jnp.cos(2 * x[1]) + jnp.sin(kmax * x[2])
                      + 0.5 * jnp.cos(x[0] + x[1]))


def _fields():
    rng = np.random.default_rng(0)
    return {
        "band_limited": (_band_limited((16, 16, 16)), (8, 8, 8)),
        "velocity": (np.array(jsyn.random_velocity(jax.random.PRNGKey(0), (16, 16, 16),
                                                     amplitude=1.0, sigma_vox=3.0)),
                     (8, 8, 8)),
        "anisotropic": (rng.standard_normal((3, 12, 16, 8)).astype(np.float32), (6, 8, 4)),
        "odd": (rng.standard_normal((9, 10, 7)).astype(np.float32), (5, 6, 4)),
    }


@pytest.mark.parametrize("name", sorted(_fields()))
def test_resample_matches_jax(name):
    f, coarse = _fields()[name]
    fine = f.shape[-3:]
    up_shape = tuple(2 * n for n in fine)
    for fn_t, fn_j, shape in ((tMR.restrict, jMR.restrict, coarse),
                              (tMR.prolong, jMR.prolong, up_shape),
                              (tMR.fourier_resample, jMR.fourier_resample, coarse)):
        got = fn_t(torch.from_numpy(f), shape)
        ref = np.asarray(fn_j(jnp.asarray(f), shape))
        assert got.shape == ref.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    # same shape in, same tensor out
    t = torch.from_numpy(f)
    assert tMR.fourier_resample(t, fine) is t


def test_transfer_algebra():
    f = torch.from_numpy(_band_limited((16, 16, 16)))
    np.testing.assert_allclose(tMR.restrict(tMR.prolong(f, (32, 32, 32)), (16, 16, 16)),
                               f, atol=5e-6)
    np.testing.assert_allclose(tMR.prolong(tMR.restrict(f, (8, 8, 8)), (16, 16, 16)),
                               f, atol=5e-6)
    for target in [(8, 8, 8), (24, 24, 24)]:
        np.testing.assert_allclose(float(tMR.fourier_resample(f, target).mean()),
                                   float(f.mean()), atol=1e-6)


@pytest.mark.parametrize("shape,kw", [((16, 16, 16), {}), ((64, 64, 64), {}),
                                      ((64, 64, 64), dict(n_levels=2)),
                                      ((8, 8, 8), {}), ((256, 256, 256), dict(n_levels=3)),
                                      ((32, 16, 64), dict(min_size=4))])
def test_default_level_shapes_match_jax(shape, kw):
    assert tMR.default_level_shapes(shape, **kw) == jMR.default_level_shapes(shape, **kw)


def test_solve_multires_rejects_bad_levels():
    m = torch.zeros((16, 16, 16))
    cfg = tT.TransportConfig()
    with pytest.raises(ValueError, match="finest level"):
        tMR.solve_multires(m, m, cfg, levels=[(8, 8, 8), (12, 12, 12)])
    with pytest.raises(ValueError, match="level_weight_dtypes"):
        tMR.solve_multires(m, m, cfg, levels=[(8, 8, 8), (16, 16, 16)],
                           level_weight_dtypes=[None])

"""Port parity, kernel K5: the plain version of the valid-mode stencil
(``repro_torch.kernels.pencil.stencil_valid_plain``, the slab solve's x1
FD8 derivative) against the JAX package's Pallas ``stencil_pencil_valid``,
run in interpret mode as ``tests/test_kernels.py`` runs it, and against the
slicing reference ``repro.distributed.halo._fd8_x1_valid``.

Axes 0, 1 and 2, a batched stack, and slabs thinner and thicker than the
radius. Tolerances are ``test_kernels.py``'s fp32 ones: rtol 1e-5, atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import halo as jH
from repro.kernels.pencil import stencil_pencil_valid
from repro_torch.kernels import counts
from repro_torch.kernels import fd8 as tFD8
from repro_torch.kernels import pencil as tP

TOL = dict(rtol=1e-5, atol=1e-4)
TAPS = tFD8.FD8_COEFFS
R = len(TAPS)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ext_shape(n_loc, axis, dims=(10, 12)):
    shape = list(dims)
    shape.insert(axis, n_loc + 2 * R)
    return tuple(shape)


@pytest.mark.parametrize("n_loc", [2, 8, 12])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_stencil_valid_plain_matches_pallas(axis, n_loc):
    f = _rand(_ext_shape(n_loc, axis), 3 * axis + n_loc)
    scale = n_loc / (2 * np.pi)
    got = tP.stencil_valid_plain(torch.from_numpy(f), axis, TAPS, scale)
    ref = stencil_pencil_valid(jnp.asarray(f), axis, TAPS, scale=scale)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("axis", [0, 2])
def test_stencil_valid_of_a_stack_matches_vmapped_pallas(axis):
    """Leading dimensions are a batch: one K5 launch for the whole stack,
    as the slab solve differentiates its (nt+1)-field trajectories."""
    fs = _rand((5,) + _ext_shape(6, axis), 11)
    got = tP.stencil_valid(torch.from_numpy(fs), axis, TAPS, 2.0)
    ref = jax.vmap(lambda g: stencil_pencil_valid(g, axis, TAPS, scale=2.0))(
        jnp.asarray(fs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("n_loc", [3, 8])
def test_stencil_valid_matches_halo_fd8_x1_valid(n_loc, lead):
    f_ext = _rand(lead + (n_loc + 2 * R, 8, 6), 20 + n_loc)
    h = 2 * np.pi / (4 * n_loc)
    got = tP.stencil_valid(torch.from_numpy(f_ext), 0, TAPS, 1.0 / h)
    ref = jH._fd8_x1_valid(jnp.asarray(f_ext), n_loc, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_valid_stencil_on_a_periodic_pad_is_the_periodic_stencil(axis):
    """On a field padded periodically by R rows, K5's plain version gives
    K1's plain version bit for bit: same taps, same order, same scale."""
    f = torch.from_numpy(_rand((2, 9, 10, 7), 40 + axis))
    d = f.dim() - 3 + axis
    n = f.shape[d]
    padded = f.index_select(d, torch.remainder(torch.arange(-R, n + R), n))
    torch.testing.assert_close(tP.stencil_valid_plain(padded, axis, TAPS, 1.5),
                               tP.stencil_axis_plain(f, axis, TAPS, False, 1.5),
                               rtol=0, atol=0)


def test_stencil_valid_wrapper_counts_and_checks():
    counts.reset()
    f = torch.from_numpy(_rand((10, 4, 4), 7))
    out = tP.stencil_valid(f, 0, TAPS, 3.0)
    torch.testing.assert_close(out, tP.stencil_valid_plain(f, 0, TAPS, 3.0),
                               rtol=0, atol=0)
    assert out.shape == (2, 4, 4)
    assert counts.snapshot() == {"plain:stencil_valid:fd8": 1}
    counts.reset()
    with pytest.raises(ValueError, match="too short"):
        tP.stencil_valid(f[:8], 0, TAPS)
    with pytest.raises(ValueError, match="axis"):
        tP.stencil_valid(f, 3, TAPS)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tP.stencil_valid(torch.zeros((10, 4, 4), device="meta"), 0, TAPS)

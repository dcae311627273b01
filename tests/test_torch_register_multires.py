"""Port parity, ``register_multires`` as a whole: the 16^3 synthetic pair of
``repro.data.synthetic.make_pair`` (seed 0, fd8-cubic, handed over as numpy)
on the pyramid [8^3, 16^3] against the JAX package's ``register_multires``.

Per-level Newton iterations must be equal and the final velocity within
1e-4 * max|v| (as ``tests/test_torch_register.py``). A pyramid with bf16
weights on the coarse level (``level_weight_dtypes=[bf16, None]``, the
paper's reduced-precision warm start) must converge with finite velocities.
"""

import jax
import numpy as np
import torch

from repro.core import registration as jR
from repro.data import synthetic as jsyn
from repro_torch.core import gauss_newton as tGN
from repro_torch.core import multires as tMR
from repro_torch.core import registration as tR

SHAPE = (16, 16, 16)
LEVELS = [(8, 8, 8), (16, 16, 16)]


def test_register_multires_matches_jax():
    pair = jsyn.make_pair(jax.random.PRNGKey(0), SHAPE)
    m0, m1 = np.asarray(pair.m0), np.asarray(pair.m1)
    ref = jR.register_multires(pair.m0, pair.m1, levels=LEVELS)
    got = tR.register_multires(m0, m1, levels=LEVELS, device="cpu")
    assert [lr.iters for lr in got.level_results] == [lr.iters for lr in ref.level_results]
    assert [lr.shape for lr in got.level_results] == LEVELS
    assert got.iters == ref.iters and got.fine_iters == ref.fine_iters
    assert got.converged == ref.converged
    v = np.asarray(ref.v)
    dv = float(np.max(np.abs(got.v.numpy() - v)))
    assert dv <= 1e-4 * float(np.max(np.abs(v))), dv
    np.testing.assert_allclose(got.mismatch_rel, ref.mismatch_rel, rtol=1e-4)
    assert [h["grid"] for h in got.history] == [h["grid"] for h in ref.history]

    mixed = tMR.solve_multires(torch.from_numpy(m0), torch.from_numpy(m1),
                               tR.make_transport_config("fd8-cubic"), tGN.GNConfig(),
                               levels=LEVELS, level_weight_dtypes=[torch.bfloat16, None])
    assert mixed.converged and bool(torch.isfinite(mixed.v).all())
    assert mixed.v.shape == (3,) + SHAPE

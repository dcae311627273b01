"""Port parity, every variant tag of ``register``: the reduced gradient, the
state trajectory and the det F statistics of each variant (FD8 or FFT first
derivatives; B-spline, Lagrange or linear interpolation, i.e. K2/K3 with
support 4 or 2) against the JAX package on an 8^3 problem.

Tolerance: 1e-5 * max(scale, 1) for fields, 1e-4 for det F statistics.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import gradient as jGR
from repro.core import metrics as jMT
from repro.core.registration import VARIANTS as J_VARIANTS
from repro.core.registration import make_transport_config as j_cfg
from repro.data import synthetic as jsyn
from repro_torch.core import gradient as tGR
from repro_torch.core import hessian as tHS
from repro_torch.core import metrics as tMT
from repro_torch.core.registration import VARIANTS as T_VARIANTS
from repro_torch.core.registration import make_transport_config as t_cfg

SHAPE = (8, 8, 8)
BETA, GAMMA = 5e-4, 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_scaled(got, ref, rel=1e-5):
    ref = np.asarray(ref)
    dev = float(np.max(np.abs(np.asarray(got) - ref)))
    assert dev <= rel * max(float(np.max(np.abs(ref))), 1.0), dev


@pytest.fixture(scope="module")
def problem():
    pair = jsyn.make_pair(jax.random.PRNGKey(21), SHAPE, amplitude=0.5)
    v = 0.3 * jsyn.random_velocity(jax.random.PRNGKey(22), SHAPE)
    vt = jsyn.random_velocity(jax.random.PRNGKey(23), SHAPE, amplitude=0.2)
    return pair, v, vt


def test_variant_tables_agree():
    assert T_VARIANTS == J_VARIANTS


@pytest.mark.parametrize("variant", sorted(T_VARIANTS))
def test_variant_gradient_and_metrics_match_jax(problem, variant):
    pair, v, vt = problem
    jgs = jax.jit(lambda m0, m1, v_: jGR.evaluate(m0, m1, v_, BETA, GAMMA,
                                                  j_cfg(variant)))(pair.m0, pair.m1, v)
    cfg = t_cfg(variant)
    gs = tGR.evaluate(_t(pair.m0), _t(pair.m1), _t(v), BETA, GAMMA, cfg)
    _assert_scaled(gs.g.numpy(), jgs.g)
    _assert_scaled(gs.m_traj.numpy(), jgs.m_traj)
    _assert_scaled(gs.lam_traj.numpy(), jgs.lam_traj)
    jdet = jMT.detF_stats(v, j_cfg(variant))
    tdet = tMT.detF_stats(_t(v), cfg)
    for key in ("min", "mean", "max"):
        np.testing.assert_allclose(float(tdet[key]), float(jdet[key]), atol=1e-4)
    # the port's fused matvec agrees with its plan path for this variant
    fused = tHS.matvec(_t(vt), gs, _t(v), BETA, GAMMA, t_cfg(variant, use_fused_matvec=True))
    plan = tHS.matvec(_t(vt), gs, _t(v), BETA, GAMMA, cfg)
    _assert_scaled(fused.numpy(), plan.numpy())

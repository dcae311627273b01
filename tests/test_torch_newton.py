"""Port parity, one Gauss-Newton step: the port's host-loop Newton step
(PCG and Armijo line search as Python loops) against JAX's jitted step on an
8^3 problem, so that a failing full solve points at the step.

PCG iterations and line-search evaluations must be equal; the accepted step
``alpha``, the gradient norm and the new velocity agree within 1e-5
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gauss_newton as jGN
from repro.core.registration import make_transport_config as j_cfg
from repro.data import synthetic as jsyn
from repro_torch.core import gauss_newton as tGN
from repro_torch.core.registration import make_transport_config as t_cfg

SHAPE = (8, 8, 8)
BETA, GAMMA, ETA = 5e-4, 1e-4, 0.5


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def steps():
    pair = jsyn.make_pair(jax.random.PRNGKey(0), SHAPE)
    step = jax.jit(jGN._build_step(j_cfg("fd8-cubic"), jGN.GNConfig()))
    v0 = jnp.zeros((3,) + SHAPE, jnp.float32)
    first = step(pair.m0, pair.m1, v0, jnp.float32(BETA), jnp.float32(GAMMA),
                 jnp.float32(ETA))
    second = step(pair.m0, pair.m1, first.v_new, jnp.float32(BETA), jnp.float32(GAMMA),
                  jnp.float32(0.3))
    return dict(m0=np.asarray(pair.m0), m1=np.asarray(pair.m1),
                v1=np.asarray(first.v_new),
                ref=[(first, np.zeros((3,) + SHAPE, np.float32), ETA),
                     (second, np.asarray(first.v_new), 0.3)])


@pytest.mark.parametrize("k", [0, 1], ids=["from_zero", "second_step"])
def test_newton_step_matches_jax(steps, k):
    ref, v_in, eta = steps["ref"][k]
    got = tGN.newton_step(_t(steps["m0"]), _t(steps["m1"]), _t(v_in), BETA, GAMMA, eta,
                          t_cfg("fd8-cubic"), tGN.GNConfig())
    assert got.pcg_iters == int(ref.pcg_iters)
    assert got.ls_evals == int(ref.ls_evals)
    np.testing.assert_allclose(float(got.alpha), float(ref.alpha), rtol=1e-5)
    np.testing.assert_allclose(float(got.gnorm), float(ref.gnorm), rtol=1e-5)
    np.testing.assert_allclose(float(got.j_total), float(ref.j_total), rtol=1e-5)
    v_new = np.asarray(ref.v_new)
    dv = float(np.max(np.abs(got.v_new.numpy() - v_new)))
    assert dv <= 1e-5 * float(np.max(np.abs(v_new))), dv


def test_fused_newton_step_matches_plan_step(steps):
    """The step with the fused (K3) matvec takes the same PCG and line-search
    path as the plan-path step."""
    args = (_t(steps["m0"]), _t(steps["m1"]), _t(steps["v1"]), BETA, GAMMA, 0.3)
    a = tGN.newton_step(*args, t_cfg("fd8-cubic"), tGN.GNConfig())
    b = tGN.newton_step(*args, t_cfg("fd8-cubic", use_fused_matvec=True), tGN.GNConfig())
    assert (a.pcg_iters, a.ls_evals) == (b.pcg_iters, b.ls_evals)
    scale = float(a.v_new.abs().max())
    assert float((a.v_new - b.v_new).abs().max()) <= 1e-5 * scale

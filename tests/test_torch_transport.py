"""Port parity, semi-Lagrangian transport: characteristics, the four solves,
trajectory gradients and the body force, against the JAX package on a 16^3
synthetic problem handed over as numpy arrays.

The state solve is held to ``tests/test_kernels.py``'s 3e-5 (JAX's own
Pallas-vs-XLA transport bound). The other solves and the body force are held
to 1e-5 of JAX; they are given JAX's footpoints, so the bound measures the
solves alone. (``tests/test_plan.py`` holds JAX's plan and plan-free paths
to 1e-6 and 3e-6; between two frameworks the gather and FFT sums run in
another order, and 1e-5 leaves margin over the deviations observed on this
problem, 4e-8 to 4e-7, with footpoints equal.)
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import transport as jT
from repro.data import synthetic as jsyn
from repro_torch.core import semilag as tSL
from repro_torch.core import transport as tT

SHAPE = (16, 16, 16)
J_CFG = jT.TransportConfig(interp="cubic_bspline", deriv="fd8", nt=4)
T_CFG = tT.TransportConfig(interp="cubic_bspline", deriv="fd8", nt=4)
TOL = 1e-5


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def jax_side():
    pair = jsyn.make_pair(jax.random.PRNGKey(9), SHAPE, amplitude=0.3)
    v = 0.3 * jsyn.random_velocity(jax.random.PRNGKey(10), SHAPE)
    vt = jsyn.random_velocity(jax.random.PRNGKey(11), SHAPE, amplitude=0.2)
    foot = jT.footpoints(v, J_CFG, sign=1.0)
    foot_adj = jT.footpoints(v, J_CFG, sign=-1.0)
    m_traj = jT.solve_state(pair.m0, v, J_CFG, foot=foot)
    gm = jT.grad_traj(m_traj, J_CFG)
    lam_traj = jT.solve_adjoint(pair.m1 - m_traj[-1], v, J_CFG, foot_adj=foot_adj)
    out = dict(m0=pair.m0, m1=pair.m1, v=v, vt=vt, foot=foot, foot_adj=foot_adj,
               m_traj=m_traj, grad_m_traj=gm, lam_traj=lam_traj,
               mt1=jT.solve_inc_state(vt, v, m_traj, J_CFG, foot=foot, grad_m_traj=gm),
               lt_traj=jT.solve_inc_adjoint(m_traj[-1] - pair.m1, v, J_CFG,
                                            foot_adj=foot_adj),
               body=jT.body_force(lam_traj, m_traj, J_CFG, grad_m_traj=gm))
    return {k: _np(a) for k, a in out.items()}


def _within(got, ref, tol):
    dev = float(np.max(np.abs(np.asarray(got) - ref)))
    assert dev <= tol, dev


def test_footpoints_match_jax(jax_side):
    """Footpoints are index units (up to N); fp32 resolution there is ~2e-6."""
    v = _t(jax_side["v"])
    _within(tT.footpoints(v, T_CFG, sign=1.0).numpy(), jax_side["foot"], TOL)
    _within(tT.footpoints(v, T_CFG, sign=-1.0).numpy(), jax_side["foot_adj"], TOL)


def test_solve_state_matches_jax(jax_side):
    v = _t(jax_side["v"])
    m0 = _t(jax_side["m0"])
    got = tT.solve_state(m0, v, T_CFG, foot=_t(jax_side["foot"]))
    assert got.shape == (T_CFG.nt + 1,) + SHAPE
    _within(got.numpy(), jax_side["m_traj"], 3e-5)
    # tracing its own footpoints, the port still lands within 3e-5
    _within(tT.solve_state(m0, v, T_CFG).numpy(), jax_side["m_traj"], 3e-5)


def test_grad_traj_matches_jax(jax_side):
    got = tT.grad_traj(_t(jax_side["m_traj"]), T_CFG)
    assert got.shape == (T_CFG.nt + 1, 3) + SHAPE
    ref = jax_side["grad_m_traj"]
    _within(got.numpy(), ref, TOL * max(1.0, float(np.max(np.abs(ref)))))


def test_solve_adjoint_matches_jax(jax_side):
    lam1 = _t(jax_side["m1"] - jax_side["m_traj"][-1])
    got = tT.solve_adjoint(lam1, _t(jax_side["v"]), T_CFG, foot_adj=_t(jax_side["foot_adj"]))
    _within(got.numpy(), jax_side["lam_traj"], TOL)
    # forward time order: the terminal condition sits at the end
    np.testing.assert_array_equal(got[-1].numpy(), lam1.numpy())


def test_solve_inc_state_matches_jax(jax_side):
    v, vt = _t(jax_side["v"]), _t(jax_side["vt"])
    m_traj = _t(jax_side["m_traj"])
    got = tT.solve_inc_state(vt, v, m_traj, T_CFG, foot=_t(jax_side["foot"]),
                             grad_m_traj=_t(jax_side["grad_m_traj"]))
    _within(got.numpy(), jax_side["mt1"], TOL)
    # without cached gradients the solve computes them itself
    got2 = tT.solve_inc_state(vt, v, m_traj, T_CFG, foot=_t(jax_side["foot"]))
    _within(got2.numpy(), jax_side["mt1"], TOL)


def test_solve_inc_adjoint_matches_jax(jax_side):
    mt1 = _t(jax_side["m_traj"][-1] - jax_side["m1"])
    got = tT.solve_inc_adjoint(mt1, _t(jax_side["v"]), T_CFG,
                               foot_adj=_t(jax_side["foot_adj"]))
    _within(got.numpy(), jax_side["lt_traj"], TOL)


def test_body_force_matches_jax(jax_side):
    lam, m = _t(jax_side["lam_traj"]), _t(jax_side["m_traj"])
    got = tT.body_force(lam, m, T_CFG, grad_m_traj=_t(jax_side["grad_m_traj"]))
    _within(got.numpy(), jax_side["body"], TOL)
    _within(tT.body_force(lam, m, T_CFG).numpy(), jax_side["body"], TOL)


def test_sl_step_with_source_is_heun(jax_side):
    """The RK2 source step in the port's own terms: zero source coefficient
    and zero source reduce it to plain advection through the plan."""
    foot = _t(jax_side["foot"])
    plan = tSL.build_plan(foot, "cubic_bspline")
    f = _t(jax_side["m0"])
    zero = torch.zeros_like(f)
    got = tSL.sl_step_with_source(f, zero, zero, foot, 0.25, plan=plan)
    np.testing.assert_array_equal(got.numpy(), tSL.sl_step(f, foot, plan=plan).numpy())

"""Port parity, the plan-free path (``use_plan=False``): semi-Lagrangian steps
without a plan, the four transport solves, ``gradient.evaluate`` and the
Hessian matvec, against the JAX package on a 12^3 problem (that of
``tests/test_plan.py``) handed over as numpy arrays.

Tolerances: SL steps 1e-6 (``test_plan.py``'s plan vs plan-free bound);
solves 1e-5 of JAX, given JAX's footpoints (``test_torch_transport.py``'s
bound); ``evaluate().g`` and the matvec 1e-5 * max(scale, 1)
(``test_torch_gradient_hessian.py``). The port's own plan-free matvec equals
its plan-path matvec within ``test_plan.py``'s 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gradient as jGR
from repro.core import hessian as jHS
from repro.core import semilag as jSL
from repro.core import transport as jT
from repro.data import synthetic as jsyn
from repro_torch.core import gradient as tGR
from repro_torch.core import hessian as tHS
from repro_torch.core import semilag as tSL
from repro_torch.core import transport as tT
from repro_torch.kernels import counts

SHAPE = (12, 12, 12)
BETA, GAMMA = 1e-3, 1e-4
J_CFG = jT.TransportConfig(interp="cubic_bspline", deriv="fd8", nt=4, use_plan=False)
T_CFG = tT.TransportConfig(interp="cubic_bspline", deriv="fd8", nt=4, use_plan=False)
T_CFG_PLAN = dataclasses.replace(T_CFG, use_plan=True)


def _t(x):
    return torch.from_numpy(np.array(x))


def _within(got, ref, tol):
    dev = float(np.max(np.abs(np.asarray(got) - np.asarray(ref))))
    assert dev <= tol, dev


def _within_scaled(got, ref, rel=1e-5):
    ref = np.asarray(ref)
    _within(got, ref, rel * max(float(np.max(np.abs(ref))), 1.0))


@pytest.fixture(scope="module")
def jax_side():
    pair = jsyn.make_pair(jax.random.PRNGKey(9), SHAPE, amplitude=0.3)
    v = 0.3 * jsyn.random_velocity(jax.random.PRNGKey(10), SHAPE)
    vt = jsyn.random_velocity(jax.random.PRNGKey(11), SHAPE, amplitude=0.2)
    foot = jT.footpoints(v, J_CFG, sign=1.0)
    foot_adj = jT.footpoints(v, J_CFG, sign=-1.0)
    m_traj = jT.solve_state(pair.m0, v, J_CFG, foot=foot)
    gs = jax.jit(lambda m0, m1, v_: jGR.evaluate(m0, m1, v_, BETA, GAMMA, J_CFG))(
        pair.m0, pair.m1, v)
    hv = jax.jit(lambda vt_: jHS.matvec(vt_, gs, v, BETA, GAMMA, J_CFG))(vt)
    stack = jnp.stack([pair.m0, pair.m1])
    out = dict(
        m0=pair.m0, m1=pair.m1, v=v, vt=vt, foot=foot, foot_adj=foot_adj, m_traj=m_traj,
        lam_traj=jT.solve_adjoint(pair.m1 - m_traj[-1], v, J_CFG, foot_adj=foot_adj),
        mt1=jT.solve_inc_state(vt, v, m_traj, J_CFG, foot=foot),
        lt_traj=jT.solve_inc_adjoint(m_traj[-1] - pair.m1, v, J_CFG, foot_adj=foot_adj),
        step=jSL.sl_step(pair.m0, foot, "cubic_bspline"),
        many=jSL.sl_step_many(stack, foot, "cubic_bspline"),
        with_source=jSL.sl_step_with_source(pair.m1, pair.m0, pair.m1, foot, 0.25),
        g=gs.g, hv=hv)
    return {k: np.asarray(a) for k, a in out.items()}


def test_sl_steps_without_plan_match_jax(jax_side):
    foot = _t(jax_side["foot"])
    m0, m1 = _t(jax_side["m0"]), _t(jax_side["m1"])
    counts.reset()
    _within(tSL.sl_step(m0, foot).numpy(), jax_side["step"], 1e-6)
    # the stack shares its footpoints: one K4 launch for both fields
    assert counts.snapshot()["plain:interp3d:cubic_bspline"] == 1
    _within(tSL.sl_step_many(torch.stack([m0, m1]), foot).numpy(), jax_side["many"], 1e-6)
    _within(tSL.sl_step_with_source(m1, m0, m1, foot, 0.25).numpy(),
            jax_side["with_source"], 1e-6)
    assert tT.interp_plan(foot, T_CFG) is None


def test_solves_without_plans_match_jax(jax_side):
    v, vt, m1 = _t(jax_side["v"]), _t(jax_side["vt"]), jax_side["m1"]
    foot, foot_adj = _t(jax_side["foot"]), _t(jax_side["foot_adj"])
    m_traj = tT.solve_state(_t(jax_side["m0"]), v, T_CFG, foot=foot)
    _within(m_traj.numpy(), jax_side["m_traj"], 1e-5)
    lam = tT.solve_adjoint(_t(m1 - jax_side["m_traj"][-1]), v, T_CFG, foot_adj=foot_adj)
    _within(lam.numpy(), jax_side["lam_traj"], 1e-5)
    mt1 = tT.solve_inc_state(vt, v, _t(jax_side["m_traj"]), T_CFG, foot=foot)
    _within(mt1.numpy(), jax_side["mt1"], 1e-5)
    lt = tT.solve_inc_adjoint(_t(jax_side["m_traj"][-1] - m1), v, T_CFG, foot_adj=foot_adj)
    _within(lt.numpy(), jax_side["lt_traj"], 1e-5)


def test_planfree_solves_equal_plan_path(jax_side):
    """The port's two paths, as ``test_plan.py`` holds JAX's."""
    v, vt, m0 = _t(jax_side["v"]), _t(jax_side["vt"]), _t(jax_side["m0"])
    foot, foot_adj = _t(jax_side["foot"]), _t(jax_side["foot_adj"])
    m_on = tT.solve_state(m0, v, T_CFG_PLAN, foot=foot)
    m_off = tT.solve_state(m0, v, T_CFG, foot=foot)
    _within(m_on.numpy(), m_off.numpy(), 1e-6)
    m1 = _t(jax_side["m1"])
    _within(tT.solve_adjoint(m1, v, T_CFG_PLAN, foot_adj=foot_adj).numpy(),
            tT.solve_adjoint(m1, v, T_CFG, foot_adj=foot_adj).numpy(), 3e-6)
    _within(tT.solve_inc_state(vt, v, m_on, T_CFG_PLAN, foot=foot,
                               grad_m_traj=tT.grad_traj(m_on, T_CFG)).numpy(),
            tT.solve_inc_state(vt, v, m_off, T_CFG, foot=foot).numpy(), 1e-6)


def test_evaluate_and_matvec_without_plans(jax_side):
    args = (_t(jax_side["m0"]), _t(jax_side["m1"]), _t(jax_side["v"]), BETA, GAMMA)
    gs = tGR.evaluate(*args, T_CFG)
    assert gs.plan_fwd is None and gs.plan_adj is None and gs.grad_m_traj is None
    _within_scaled(gs.g.numpy(), jax_side["g"])
    vt, v = _t(jax_side["vt"]), _t(jax_side["v"])
    hv = tHS.matvec(vt, gs, v, BETA, GAMMA, T_CFG)
    _within_scaled(hv.numpy(), jax_side["hv"])
    hv_plan = tHS.matvec(vt, tGR.evaluate(*args, T_CFG_PLAN), v, BETA, GAMMA, T_CFG_PLAN)
    _within(hv.numpy(), hv_plan.numpy(), 1e-6)
    assert float(hv.abs().max()) > 1e-4  # a non-degenerate problem

"""Port parity, gradient + Hessian matvec + PCG: ``gradient.evaluate`` and
both matvec paths (plan path, fused K3 path) against the JAX package on a
16^3 problem, with JAX's ``GradientState`` carried across through
``repro_torch.interop`` so that a matvec fault shows apart from a gradient
fault.

Tolerance: 1e-5 * max(scale, 1), the bound ``tests/test_fused_matvec.py``
puts between JAX's own two matvec paths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gradient as jGR
from repro.core import hessian as jHS
from repro.core import pcg as jPCG
from repro.core import spectral as jS
from repro.core.registration import make_transport_config as j_cfg
from repro.data import synthetic as jsyn
from repro_torch import interop
from repro_torch.core import gradient as tGR
from repro_torch.core import hessian as tHS
from repro_torch.core import pcg as tPCG
from repro_torch.core import spectral as tS
from repro_torch.core.registration import make_transport_config as t_cfg

BETA, GAMMA = 5e-4, 1e-4
SHAPE = (16, 16, 16)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_scaled(got, ref, rel=1e-5):
    ref = np.asarray(ref)
    dev = float(np.max(np.abs(np.asarray(got) - ref)))
    scale = float(np.max(np.abs(ref)))
    assert dev <= rel * max(scale, 1.0), (dev, scale)


@pytest.fixture(scope="module")
def problem():
    pair = jsyn.make_pair(jax.random.PRNGKey(3), SHAPE, amplitude=0.5)
    v = 0.3 * jsyn.random_velocity(jax.random.PRNGKey(4), SHAPE)
    vt = jsyn.random_velocity(jax.random.PRNGKey(5), SHAPE, amplitude=0.2)
    cfg = j_cfg("fd8-cubic")
    gs = jax.jit(lambda m0, m1, v_: jGR.evaluate(m0, m1, v_, BETA, GAMMA, cfg))(
        pair.m0, pair.m1, v)
    hv = {}
    for fused in (False, True):
        c = j_cfg("fd8-cubic", use_fused_matvec=fused)
        hv[fused] = np.asarray(jax.jit(
            lambda vt_, c=c: jHS.matvec(vt_, gs, v, BETA, GAMMA, c))(vt))
    return dict(m0=np.asarray(pair.m0), m1=np.asarray(pair.m1), v=np.asarray(v),
                vt=np.asarray(vt), gs=gs, hv=hv)


def test_evaluate_matches_jax(problem):
    gs = tGR.evaluate(_t(problem["m0"]), _t(problem["m1"]), _t(problem["v"]),
                      BETA, GAMMA, t_cfg("fd8-cubic"))
    jgs = problem["gs"]
    _assert_scaled(gs.g.numpy(), jgs.g)
    _assert_scaled(gs.m_traj.numpy(), jgs.m_traj)
    _assert_scaled(gs.lam_traj.numpy(), jgs.lam_traj)
    _assert_scaled(gs.divv.numpy(), jgs.divv)
    _assert_scaled(gs.grad_m_traj.numpy(), jgs.grad_m_traj)
    np.testing.assert_allclose(float(gs.j_mismatch), float(jgs.j_mismatch), rtol=1e-4)
    np.testing.assert_allclose(float(gs.j_reg), float(jgs.j_reg), rtol=1e-4)
    for tp, jp in ((gs.plan_fwd, jgs.plan_fwd), (gs.plan_adj, jgs.plan_adj)):
        for ti, ji in zip(tp.idx, jp.idx):
            # footpoints differ by fp32 noise; a tap index may flip only
            # where a footpoint sits on a grid plane
            assert np.mean(ti.numpy() != np.asarray(ji)) < 1e-3


@pytest.mark.parametrize("fused", [False, True], ids=["plan", "fused"])
def test_matvec_on_carried_state_matches_jax(problem, fused):
    gs = interop.gradient_state_from_numpy(problem["gs"]._asdict(), device="cpu")
    cfg = t_cfg("fd8-cubic", use_fused_matvec=fused)
    got = tHS.matvec(_t(problem["vt"]), gs, _t(problem["v"]), BETA, GAMMA, cfg)
    _assert_scaled(got.numpy(), problem["hv"][fused])


def test_port_fused_matvec_matches_its_plan_path(problem):
    gs = tGR.evaluate(_t(problem["m0"]), _t(problem["m1"]), _t(problem["v"]),
                      BETA, GAMMA, t_cfg("fd8-cubic"))
    vt, v = _t(problem["vt"]), _t(problem["v"])
    ref = tHS.matvec(vt, gs, v, BETA, GAMMA, t_cfg("fd8-cubic"))
    got = tHS.matvec(vt, gs, v, BETA, GAMMA, t_cfg("fd8-cubic", use_fused_matvec=True))
    _assert_scaled(got.numpy(), ref.numpy())
    # the fused path is taken only when the state carries plans and gradients
    calls = []
    orig = tHS._matvec_fused
    try:
        tHS._matvec_fused = lambda *a, **k: (calls.append(1), orig(*a, **k))[1]
        cfg_f = t_cfg("fd8-cubic", use_fused_matvec=True)
        tHS.matvec(vt, gs, v, BETA, GAMMA, cfg_f)
        assert calls
        calls.clear()
        tHS.matvec(vt, dataclasses.replace(gs, grad_m_traj=None), v, BETA, GAMMA, cfg_f)
        assert not calls
    finally:
        tHS._matvec_fused = orig


def test_pcg_matches_jax_on_regularization_system():
    """PCG inverts (A + c I) with the spectral preconditioner: same
    iteration count as JAX, solution within 1e-5 * max|x|, and within
    test_gauss_newton.py's 2e-3 of the true solution."""
    beta, gamma, c = 1e-2, 1e-3, 0.5
    v = np.asarray(jsyn.random_velocity(jax.random.PRNGKey(0), (12, 12, 12),
                                        amplitude=1.0))

    def jmv(x):
        return jS.apply_regop(x, beta, gamma) + c * x

    def tmv(x):
        return tS.apply_regop(x, beta, gamma) + c * x

    jsol = jPCG.solve(jmv, jmv(jnp.asarray(v)), jPCG.make_reg_preconditioner(beta, gamma),
                      tol=1e-6, max_iters=200)
    tsol = tPCG.solve(tmv, tmv(_t(v)), tPCG.make_reg_preconditioner(beta, gamma),
                      tol=1e-6, max_iters=200)
    assert tsol.iters == int(jsol.iters) < 200
    _assert_scaled(tsol.x.numpy(), jsol.x)
    np.testing.assert_allclose(tsol.x.numpy(), v, atol=2e-3)
    # a zero right-hand side stops before the first matvec
    zero = tPCG.solve(tmv, torch.zeros_like(_t(v)),
                      tPCG.make_reg_preconditioner(beta, gamma), tol=0.5)
    assert zero.iters == 0 and float(zero.x.abs().max()) == 0.0

"""Port parity: the NCC and NGF distance measures (``core.measures``).

The same numpy inputs (the 8^3 pair of ``tests/test_measures.py``, seed 2,
made by the JAX package) go through the JAX measures and the port's, for
the fd8 and fft derivatives. ``value`` (relative) and ``terminal_adjoint``
agree within 1e-5 of the field's max, the exactness tolerance
``tests/test_measures.py`` gives the terminal adjoint (observed <= 4.5e-6);
``gn_terminal`` on the JAX cache (carried across by ``interop``) too
(observed 2e-7). ``make_cache`` and ``gn_terminal`` on each package's own
cache agree within 1e-4, the GN-operator tolerance of that file: NGF's
kappa = 2 r^2 / (np2^2 nq2) divides by np2^2 where |grad m| is near the edge
parameter, and there the two FFT libraries' ~2e-7 differences in grad m
become 1.2e-5 of max kappa with fft (fd8: 2e-7). The JAX package's own
oracles run on the port: terminal
adjoint against ``torch.autograd`` of ``value`` (1e-5 relative), GN terminal
symmetric (1e-4 relative) and PSD, cache against direct (bit-equal), and
``GradientState`` carrying the cache. JAX's caches cross into the port
through ``interop``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gradient as jGR
from repro.core import measures as jM
from repro.core import transport as jT
from repro.data import synthetic as jsyn
from repro_torch import interop
from repro_torch.core import gradient as tGR
from repro_torch.core import grid as tG
from repro_torch.core import measures as tM
from repro_torch.core import transport as tT

SHAPE = (8, 8, 8)
MEASURES = ("ssd", "ncc", "ngf")
FIELD_REL = 1e-5
GN_REL = 1e-4


@pytest.fixture(scope="module")
def pair():
    p = jsyn.make_pair(jax.random.PRNGKey(2), SHAPE, amplitude=0.4, nt=2)
    rng = np.random.default_rng(7)
    return dict(m0=np.asarray(p.m0), m1=np.asarray(p.m1),
                u=rng.standard_normal(SHAPE).astype(np.float32),
                w=rng.standard_normal(SHAPE).astype(np.float32))


def _cfgs(name, deriv="fd8"):
    kw = dict(interp="cubic_bspline", deriv=deriv, nt=2, measure=name)
    return jT.TransportConfig(**kw), tT.TransportConfig(**kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rel=FIELD_REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(got - ref)))
    assert err <= rel * scale, f"max|port - jax| = {err:.3e}, scale {scale:.3e}"


def test_registry_resolves_every_jax_measure():
    assert tM.available() == jM.available() == ("ncc", "ngf", "ssd")
    assert tM.resolve("NCC").name == "ncc" and tM.resolve("ngf").name == "ngf"
    custom = tM.NGF(eps=0.05)
    assert tM.resolve(custom) is custom
    assert tM.NGF(eps=0.05) != tM.NGF(eps=0.1) and hash(tM.NCC()) == hash(tM.NCC())
    with pytest.raises(ValueError, match="unknown distance measure"):
        tM.resolve("mutual_information")


@pytest.mark.parametrize("deriv", ["fd8", "fft"])
@pytest.mark.parametrize("name", ["ncc", "ngf"])
def test_measure_matches_jax(pair, name, deriv):
    jc, tc = _cfgs(name, deriv)
    jm, tm = jM.resolve(name), tM.resolve(name)
    m0, m1, u = pair["m0"], pair["m1"], pair["u"]
    np.testing.assert_allclose(float(tm.value(_t(m0), _t(m1), tc)),
                               float(jm.value(jnp.asarray(m0), jnp.asarray(m1), jc)),
                               rtol=FIELD_REL)
    _close(tm.terminal_adjoint(_t(m0), _t(m1), tc), jm.terminal_adjoint(m0, m1, jc))
    jcache = jm.make_cache(m0, m1, jc)
    jgn = jm.gn_terminal(u, m0, m1, jc, cache=jcache)
    _close(tm.gn_terminal(_t(u), None, None, tc,
                          cache=interop.measure_cache_from_numpy(jcache, "cpu")), jgn)
    tcache = tm.make_cache(_t(m0), _t(m1), tc)
    for field in jcache._fields:
        _close(getattr(tcache, field), getattr(jcache, field), GN_REL)
    _close(tm.gn_terminal(_t(u), _t(m0), _t(m1), tc, cache=tcache), jgn, GN_REL)


@pytest.mark.parametrize("deriv", ["fd8", "fft"])
@pytest.mark.parametrize("name", MEASURES)
def test_terminal_adjoint_matches_autograd(pair, name, deriv):
    _, tc = _cfgs(name, deriv)
    meas = tM.resolve(name)
    mf = _t(pair["m0"]).clone().requires_grad_(True)
    (g,) = torch.autograd.grad(meas.value(mf, _t(pair["m1"]), tc), mf)
    lam_ad = -g / tG.cell_volume(SHAPE)
    lam = meas.terminal_adjoint(_t(pair["m0"]), _t(pair["m1"]), tc)
    scale = float(lam_ad.abs().max()) or 1.0
    err = float((lam - lam_ad).abs().max()) / scale
    assert err <= 1e-5, f"{name}/{deriv}: terminal adjoint off by {err:.2e}"


@pytest.mark.parametrize("deriv", ["fd8", "fft"])
@pytest.mark.parametrize("name", MEASURES)
def test_gn_terminal_symmetric_psd(pair, name, deriv):
    _, tc = _cfgs(name, deriv)
    meas = tM.resolve(name)
    m0, m1 = _t(pair["m0"]), _t(pair["m1"])
    cache = meas.make_cache(m0, m1, tc)
    u, w = _t(pair["u"]), _t(pair["w"])

    def H(x):   # gn_terminal returns -H_D x
        return -meas.gn_terminal(x, m0, m1, tc, cache=cache)

    huw = float(tG.inner(H(u), w))
    uhw = float(tG.inner(u, H(w)))
    assert abs(huw - uhw) / max(abs(huw), abs(uhw), 1e-12) <= 1e-4
    assert float(tG.inner(H(u), u)) >= -1e-5 * float(tG.inner(u, u))


@pytest.mark.parametrize("name", ["ncc", "ngf"])
def test_gn_terminal_cache_matches_direct(pair, name):
    _, tc = _cfgs(name)
    meas = tM.resolve(name)
    m0, m1, u = _t(pair["m0"]), _t(pair["m1"]), _t(pair["u"])
    cache = meas.make_cache(m0, m1, tc)
    assert torch.equal(meas.gn_terminal(u, m0, m1, tc, cache=cache),
                       meas.gn_terminal(u, m0, m1, tc))


@pytest.mark.parametrize("name,typ", [("ssd", type(None)), ("ncc", tM._NCCCache),
                                      ("ngf", tM._NGFCache)])
def test_gradient_state_carries_measure_cache(pair, name, typ):
    _, tc = _cfgs(name)
    gs = tGR.evaluate(_t(pair["m0"]), _t(pair["m1"]), torch.zeros((3,) + SHAPE),
                      5e-4, 1e-4, tc)
    assert isinstance(gs.measure_cache, typ)


@pytest.mark.parametrize("form", ["namedtuple", "mapping"])
@pytest.mark.parametrize("name", ["ncc", "ngf"])
def test_interop_carries_jax_measure_caches(pair, name, form):
    """A JAX ``GradientState``'s measure cache crosses into the port as its
    NamedTuple or as a mapping, and the port's GN terminal on it matches the
    port's own cache."""
    jc, tc = _cfgs(name)
    m0, m1 = pair["m0"], pair["m1"]
    gs = jGR.evaluate(jnp.asarray(m0), jnp.asarray(m1), jnp.zeros((3,) + SHAPE),
                      5e-4, 1e-4, jc)
    cache = gs.measure_cache
    if form == "mapping":
        cache = {k: np.asarray(v) for k, v in cache._asdict().items()}
    state = {f: getattr(gs, f) for f in ("g", "m_traj", "lam_traj", "foot_fwd",
                                          "foot_adj", "divv", "j_mismatch", "j_reg")}
    state = {k: np.asarray(v) for k, v in state.items()}
    state["measure_cache"] = cache
    tgs = interop.gradient_state_from_numpy(state, device="cpu")
    meas = tM.resolve(name)
    m_final = tgs.m_traj[-1]
    assert isinstance(tgs.measure_cache, type(meas.make_cache(m_final, _t(m1), tc)))
    u = _t(pair["u"])
    _close(meas.gn_terminal(u, None, None, tc, cache=tgs.measure_cache),
           meas.gn_terminal(u, m_final, _t(m1), tc), GN_REL)
    with pytest.raises(ValueError, match="measure cache"):
        interop.measure_cache_from_numpy({"g": m0}, device="cpu")

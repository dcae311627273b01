"""Port parity: registration with the NCC and NGF measures.

The 8^3 contrast-inverted pair of ``repro.data.synthetic.make_multimodal_pair``
(seed 5, amplitude 0.6, nt=2; handed over as numpy) is registered by the JAX
package's ``register`` and the port's, fd8-linear, nt=2, max_newton=4, for
each measure: Newton iterations, the PCG count of every step and
``converged`` must be equal, and the velocity must agree within 1e-4 *
max|v|, the tolerance of ``tests/test_torch_register.py``. The port runs
with both matvec paths (the fused one calls ``gn_terminal`` between its two
K3 transports). One JAX solve per measure for the whole file.

``make_multimodal_pair``'s intensity remaps: the port's
``multimodal_remap`` of the JAX pair's warped template equals the JAX
multimodal pair's reference, for both modes.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import registration as jR
from repro.data import synthetic as jsyn
from repro_torch.core import registration as tR
from repro_torch.data import synthetic as tS

SHAPE = (8, 8, 8)
KW = dict(variant="fd8-linear", nt=2, max_newton=4)
KEY = 5


@pytest.fixture(scope="module")
def inverted():
    p = jsyn.make_multimodal_pair(jax.random.PRNGKey(KEY), SHAPE, amplitude=0.6, nt=2,
                                  mode="inverted")
    return dict(m0=np.asarray(p.m0), m1=np.asarray(p.m1), jax={})


def _jax_result(inverted, measure):
    if measure not in inverted["jax"]:
        inverted["jax"][measure] = jR.register(inverted["m0"], inverted["m1"],
                                               measure=measure, **KW)
    return inverted["jax"][measure]


@pytest.mark.parametrize("fused", [False, True], ids=["plan_matvec", "fused_matvec"])
@pytest.mark.parametrize("measure", ["ncc", "ngf"])
def test_register_with_measure_matches_jax(inverted, measure, fused):
    ref = _jax_result(inverted, measure)
    got = tR.register(inverted["m0"], inverted["m1"], measure=measure,
                      use_fused_matvec=fused, device="cpu", **KW)
    assert got.iters == ref.iters
    assert [h["pcg_iters"] for h in got.history] == [h["pcg_iters"] for h in ref.history]
    assert got.matvecs == ref.matvecs
    assert got.converged == ref.converged
    v = np.asarray(ref.v)
    dv = float(np.max(np.abs(got.v.numpy() - v)))
    assert dv <= 1e-4 * float(np.max(np.abs(v))), dv
    for key in ("min", "mean", "max"):
        np.testing.assert_allclose(got.detF[key], ref.detF[key], atol=1e-4)


@pytest.mark.parametrize("mode", ["inverted", "quadratic"])
def test_multimodal_remap_matches_jax(mode):
    key = jax.random.PRNGKey(KEY)
    base = jsyn.make_pair(key, SHAPE, amplitude=0.6, nt=2)
    ref = jsyn.make_multimodal_pair(key, SHAPE, amplitude=0.6, nt=2, mode=mode)
    got = tS.multimodal_remap(torch.from_numpy(np.array(base.m1)), mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.m1))
    with pytest.raises(ValueError, match="unknown multimodal mode"):
        tS.multimodal_remap(got, "cubic")


def test_port_multimodal_pair_keeps_the_geometry():
    pair = tS.make_pair(1, SHAPE, device="cpu")
    for mode in ("inverted", "quadratic"):
        mm = tS.make_multimodal_pair(1, SHAPE, mode=mode, device="cpu")
        assert torch.equal(mm.m0, pair.m0) and torch.equal(mm.labels1, pair.labels1)
        assert torch.equal(mm.m1, tS.multimodal_remap(pair.m1, mode))

"""Port parity, label metrics: ``warp_labels`` (plan-free trilinear
interpolation, kernel K4's plain version here, then a 0.5 threshold) and
``dice`` against the JAX package on a 16^3 pair, with fp32 and with bf16
weights in the deformation map.

A warped label can flip only where the interpolated mask sits within fp32
noise of 0.5; the masks must agree on all but 0.1% of the voxels and Dice
within 1e-3. ``dice`` of the same masks agrees within 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import metrics as jM
from repro.core.registration import make_transport_config as j_cfg
from repro.data import synthetic as jsyn
from repro_torch.core import metrics as tM
from repro_torch.core.registration import make_transport_config as t_cfg

SHAPE = (16, 16, 16)


@pytest.fixture(scope="module")
def pair():
    p = jsyn.make_pair(jax.random.PRNGKey(2), SHAPE, amplitude=0.5)
    return p


@pytest.mark.parametrize("mixed", [False, True], ids=["fp32", "bf16"])
def test_warp_labels_and_dice_match_jax(pair, mixed):
    v = pair.v_true
    ref = np.asarray(jM.warp_labels(pair.labels0, v, j_cfg("fd8-cubic",
                                                          mixed_precision=mixed)))
    got = tM.warp_labels(torch.from_numpy(np.array(pair.labels0)),
                         torch.from_numpy(np.array(v)),
                         t_cfg("fd8-cubic", use_plan=False, mixed_precision=mixed))
    assert got.shape == SHAPE and got.dtype == torch.float32
    assert set(torch.unique(got).tolist()) <= {0.0, 1.0}
    assert float(np.mean(got.numpy() != ref)) <= 1e-3
    labels1 = np.array(pair.labels1)
    d_ref = float(jM.dice(ref, labels1))
    d_got = float(tM.dice(got, torch.from_numpy(labels1)))
    assert abs(d_got - d_ref) <= 1e-3
    np.testing.assert_allclose(float(tM.dice(torch.from_numpy(ref), torch.from_numpy(labels1))),
                               d_ref, atol=1e-6)
    # warping by the true velocity brings the template's labels onto m1's
    assert d_got > 0.9

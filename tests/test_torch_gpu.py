"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same inputs, the wrappers' checks, and a small
registration on the card against the same registration on the CPU.

Marked ``gpu``; each test decides inside itself whether there is a card and
skips without one. On a machine with a card (and without JAX, which this
file does not import):

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: K1 rtol 1e-5 / atol 1e-4; K2 and K3 1e-5 * max(|plain|, 1).
"""

import math

import pytest
import torch

from repro_torch.core import interp as I
from repro_torch.core import registration as R
from repro_torch.data import synthetic as S
from repro_torch.kernels import counts
from repro_torch.kernels import fd8 as FD8
from repro_torch.kernels import interp3d as K
from repro_torch.kernels import pencil as P
from repro_torch.kernels import prefilter as PF

pytestmark = pytest.mark.gpu

SHAPE = (24, 16, 32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(shape, seed, dev):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dev)


def _plan(dev, method, seed=1, offset=0.0):
    x = torch.stack(torch.meshgrid(*[torch.arange(n, dtype=torch.float32) for n in SHAPE],
                                   indexing="ij"))
    q = x + offset + 3.0 * (2 * torch.rand((3,) + SHAPE,
                                           generator=torch.Generator().manual_seed(seed)) - 1)
    return I.build_plan(q.to(dev), method)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_k1_matches_plain(cuda, axis):
    f = _randn((2,) + SHAPE, 0, cuda)
    scale = 1.0 / (2 * math.pi / SHAPE[axis])
    for taps, sym, sc in ((FD8.FD8_COEFFS, False, scale), (PF.PREFILTER_TAPS, True, 1.0)):
        got = P.stencil_axis(f, axis, taps, sym, sc)
        torch.testing.assert_close(got, P.stencil_axis_plain(f, axis, taps, sym, sc),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("method", I.METHODS)
@pytest.mark.parametrize("offset", [0.0, -3.0])
def test_k2_matches_plain(cuda, method, offset):
    plan = _plan(cuda, method, offset=offset)
    for lead in ((), (3,)):
        coef = _randn(lead + SHAPE, 2, cuda)
        got = K.apply_plan(coef, plan)
        ref = K.apply_plan_plain(coef, plan)
        assert float((got - ref).abs().max()) <= 1e-5 * max(float(ref.abs().max()), 1.0)


@pytest.mark.parametrize("epilogue", sorted(K.EPILOGUES))
@pytest.mark.parametrize("method", ["cubic_bspline", "linear"])
def test_k3_matches_plain(cuda, epilogue, method):
    plan = _plan(cuda, method)
    coefs = _randn((2,) + SHAPE, 3, cuda)
    extra = _randn(SHAPE, 4, cuda)
    got = K.apply_plan_fused(coefs, plan, extra, epilogue, 0.25)
    ref = K.apply_plan_fused_plain(coefs, plan, extra, epilogue, 0.25)
    assert float((got - ref).abs().max()) <= 1e-5 * max(float(ref.abs().max()), 1.0)


def test_wrappers_raise_on_what_kernels_do_not_take(cuda):
    f = _randn(SHAPE, 5, cuda)
    with pytest.raises(TypeError):
        P.stencil_axis(f.double(), 0, FD8.FD8_COEFFS, False)
    with pytest.raises(ValueError, match="contiguous"):
        P.stencil_axis(f.transpose(0, 2), 0, FD8.FD8_COEFFS, False)
    plan = _plan(cuda, "cubic_bspline")
    bf16 = I.InterpPlan(plan.idx, tuple(w.bfloat16() for w in plan.weights),
                        plan.method, plan.field_shape)
    with pytest.raises(NotImplementedError, match="A11"):
        K.apply_plan(f, bf16)
    with pytest.raises(TypeError):
        K.apply_plan(f.double(), plan)


def test_launches_are_counted_and_no_plain_version_runs(cuda):
    f = _randn((2,) + SHAPE, 6, cuda)
    plan = _plan(cuda, "cubic_bspline")
    counts.reset()
    K.apply_plan_fused(PF.prefilter3d(f), plan, f[0], "inc_state", 0.25)
    K.apply_plan(f, plan)
    FD8.fd8_grad(f[0])
    torch.cuda.synchronize()
    assert counts.snapshot() == {"stencil_axis:prefilter": 3, "apply_plan_fused:inc_state": 1,
                                 "apply_plan": 1, "stencil_axis:fd8": 3}


def test_register_on_card_matches_cpu(cuda):
    pair = S.make_pair(0, (16, 16, 16), device="cpu")
    ref = R.register(pair.m0, pair.m1, device="cpu")
    got = R.register(pair.m0, pair.m1, use_fused_matvec=True, device=cuda)
    assert got.iters == ref.iters and got.converged == ref.converged
    assert [h["pcg_iters"] for h in got.history] == [h["pcg_iters"] for h in ref.history]
    assert float((got.v.cpu() - ref.v).abs().max()) <= 1e-4 * float(ref.v.abs().max())

"""Port parity of the roofline toolkit (``repro_torch.roofline``): the LM's
``model_flops`` against ``repro.roofline.lm``'s for every arch of
``ARCHS`` and every shape of ``SHAPES`` (and decode with a token count),
and ``kernel_roofline`` / ``achieved_fraction`` / ``roofline_terms``
against ``repro.roofline.analysis`` with the same ``hw`` constants. The
port's own constants are the H100 SXM's data-sheet peaks, which
``chip_smoke.py`` reads from this module. Exact equality: the same Python
float arithmetic in the same order.
"""

import dataclasses
import sys

import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.roofline import analysis as JA
from repro.roofline import lm as JL
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.roofline import analysis as TA
from repro_torch.roofline import lm as TL


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_match_jax(arch, shape):
    for dec in (None, 1, 64):
        assert TL.model_flops(ARCHS[arch], SHAPES[shape], dec) == \
            JL.model_flops(JARCHS[arch], JSHAPES[shape], dec)
    smoke = TL.model_flops(ARCHS[arch].smoke(), SHAPES[shape])
    assert smoke == JL.model_flops(JARCHS[arch].smoke(), JSHAPES[shape]) and smoke > 0


CASES = [(1e12, 1e9, 0.0), (3e9, 8e9, 1e6), (1e6, 1e3, 5e9), (0.0, 0.0, 0.0), (5e14, 2e12, 1e11)]


@pytest.mark.parametrize("flops,mem,coll", CASES)
def test_kernel_roofline_matches_jax_with_the_same_hw(flops, mem, coll):
    for hw in (JA.HW, TA.HW, dict(peak_flops=1e12, hbm_bw=1e11, link_bw=1e10)):
        got = TA.kernel_roofline(flops, mem, coll, hw=dict(hw))
        want = JA.kernel_roofline(flops, mem, coll, hw=dict(hw))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        if got.roofline_s > 0:
            for t in (got.roofline_s / 2, got.roofline_s, 3 * got.roofline_s):
                assert TA.achieved_fraction(got.roofline_s, t) == \
                    JA.achieved_fraction(want.roofline_s, t)
    assert TA.achieved_fraction(1.0, 0.0) == 0.0


@pytest.mark.parametrize("flops,mem,coll", CASES)
def test_roofline_terms_match_jax_under_the_same_constants(flops, mem, coll, monkeypatch):
    monkeypatch.setattr(JA, "HW", dict(TA.HW))
    for chips, mf in ((1, 0.0), (4, 1e12), (512, 3e15)):
        got = TA.roofline_terms(flops, mem, coll, chips, mf)
        want = JA.roofline_terms(flops, mem, coll, chips, mf)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_h100_constants_and_chip_smoke_reads_them():
    assert TA.HW == dict(peak_flops=989e12, peak_fp32_flops=67e12, hbm_bw=3.35e12,
                         link_bw=450e9)
    # the default bound is the card's, not the TPU v5e's
    r = TA.kernel_roofline(989e12, 0.0)
    assert r.compute_s == 1.0 and r.bound == "compute"
    assert TA.kernel_roofline(0.0, 3.35e12).memory_s == 1.0
    import pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    assert chip_smoke.PEAK_BF16_FLOPS == TA.HW["peak_flops"]
    assert chip_smoke.PEAK_FP32_FLOPS == TA.HW["peak_fp32_flops"]
    # the kernels' bounds are kernel_roofline's on these peaks
    assert chip_smoke.bound_ms(3.35e9, 1.0) == (1.0, "bytes")
    assert chip_smoke.bound_ms(1.0, 67e9) == (1.0, "operations")
    assert chip_smoke.bound_ms(1.0, 989e9, chip_smoke.PEAK_BF16_FLOPS) == (1.0, "operations")

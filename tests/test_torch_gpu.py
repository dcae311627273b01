"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same inputs, the wrappers' checks, a small
registration and a smoke LM serve on the card against the same on the CPU.

Marked ``gpu``; each test decides inside itself whether there is a card and
skips without one. On a machine with a card (and without JAX, which this
file does not import):

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: K1 and K5 rtol 1e-5 / atol 1e-4; K2, K3 and K4 (fp32 and bf16
weights) 1e-5 * max(|plain|, 1). The bf16 weights of kernel and plain version are
bit-equal (``kernels/interp3d.py``), so the bound is fp32 accumulation noise.
The plan build (``build_plan_kernel``) and the matvec's contractions
(``traj_source_kernel``, ``traj_body_force_kernel``) are held to their plain
versions on the same card bit for bit. K6: fp32 ``tests/test_flashattn.py``'s rtol = atol = 2e-4; bf16 rtol 8e-3
(one ulp of the bf16 output, at most 2^-7 |x|: kernel and plain version both
accumulate in fp32 and round once) and atol 1e-4 (fp32 order noise of outputs
near 0), with at most 5% of the elements differing at all.
"""

import dataclasses

import math

import pytest
import torch
import torch.distributed as dist

from repro_torch import checkpoint as CK
from repro_torch import serve as SV
from repro_torch.configs import ARCHS
from repro_torch.core import gradient as GR
from repro_torch.core import hessian as HS
from repro_torch.core import interp as I
from repro_torch.core import registration as R
from repro_torch.core import semilag as SL
from repro_torch.data import synthetic as S
from repro_torch.distributed import group as G
from repro_torch.kernels import contract as KC
from repro_torch.kernels import counts
from repro_torch.kernels import fd8 as FD8
from repro_torch.kernels import flashattn as FA
from repro_torch.kernels import interp3d as K
from repro_torch.kernels import pencil as P
from repro_torch.kernels import plan as KP
from repro_torch.kernels import prefilter as PF
from repro_torch.launch import serve_lm
from repro_torch.models import build_model

pytestmark = pytest.mark.gpu

SHAPE = (24, 16, 32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(shape, seed, dev):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dev)


def _queries(dev, seed=1, offset=0.0):
    x = torch.stack(torch.meshgrid(*[torch.arange(n, dtype=torch.float32) for n in SHAPE],
                                   indexing="ij"))
    q = x + offset + 3.0 * (2 * torch.rand((3,) + SHAPE,
                                           generator=torch.Generator().manual_seed(seed)) - 1)
    return q.to(dev)


def _plan(dev, method, seed=1, offset=0.0, weight_dtype=None):
    return I.build_plan(_queries(dev, seed, offset), method, weight_dtype)


#: K2 / K4 query sets: near the identity (also shifted by -3), across the
#: periodic seam (-9.5 and +(n - 0.5)), uniform over a grid larger than the
#: box budget (every block's source box over budget), on 5^3 and
#: 16 x 24 x 40 fields, a flattened output, and ``_queries``' +-3 noise
#: ("wide") and the same shifted by -9.5, where a 16 x 4 x 32 tile's box is
#: over budget and the shorter last x1 tile's is not.
QUERY_SETS = ["near", "near-3", "seam_lo", "seam_hi", "uniform", "n5", "n16x24x40", "flat",
              "wide", "wide-9.5"]
QUERY_SHAPES = {"n5": (5, 5, 5), "n16x24x40": (16, 24, 40), "uniform": (24, 24, 32)}


def _query_set(kind, dev, seed=7):
    """(field shape, query points) of one query set."""
    if kind in ("wide", "wide-9.5"):
        return SHAPE, _queries(dev, seed, -9.5 if kind == "wide-9.5" else 0.0)
    shape = QUERY_SHAPES.get(kind, SHAPE)
    gen = torch.Generator().manual_seed(seed)
    x = torch.stack(torch.meshgrid(*[torch.arange(n, dtype=torch.float32) for n in shape],
                                   indexing="ij"))
    n = torch.tensor(shape, dtype=torch.float32).reshape(3, 1, 1, 1)
    if kind == "uniform":
        q = torch.rand((3,) + shape, generator=gen) * n
    else:
        q = x + 1.5 * (2 * torch.rand((3,) + shape, generator=gen) - 1)
        q = {"near-3": q - 3.0, "seam_lo": q - 9.5, "seam_hi": q + (n - 0.5)}.get(kind, q)
    if kind == "flat":
        q = q.reshape(3, -1)
    return shape, q.contiguous().to(dev)


def _assert_scaled(got, ref):
    assert float((got - ref).abs().max()) <= 1e-5 * max(float(ref.abs().max()), 1.0)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_k1_matches_plain(cuda, axis):
    f = _randn((2,) + SHAPE, 0, cuda)
    scale = 1.0 / (2 * math.pi / SHAPE[axis])
    for taps, sym, sc in ((FD8.FD8_COEFFS, False, scale), (PF.PREFILTER_TAPS, True, 1.0)):
        got = P.stencil_axis(f, axis, taps, sym, sc)
        torch.testing.assert_close(got, P.stencil_axis_plain(f, axis, taps, sym, sc),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", ["fd8", "prefilter"])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("shape", [(3, 5, 5, 5), (3, 72, 72, 72), (3, 282, 256, 256),
                                   (2, 6, 9, 75)], ids=["n5", "n72", "slab282", "odd_n3"])
def test_k1_streaming_shapes_match_plain(cuda, shape, axis, mode):
    """The shapes K1's tiling makes awkward: n < R (the wrap goes round more
    than once), 72 and 282 rows (not a multiple of the 64-row chunk), x3 not a
    multiple of 4 (scalar shared-memory path), a K=3 stack."""
    f = _randn(shape, 11, cuda)
    if mode == "fd8":
        taps, sym, sc = FD8.FD8_COEFFS, False, 1.0 / (2 * math.pi / shape[1 + axis])
    else:
        taps, sym, sc = PF.PREFILTER_TAPS, True, 1.0
    got = P.stencil_axis(f, axis, taps, sym, sc)
    torch.testing.assert_close(got, P.stencil_axis_plain(f, axis, taps, sym, sc),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_k5_matches_plain(cuda, axis):
    """Valid-mode stencil on a stack whose ``axis`` carries 2 x 4 halo rows,
    on a slab thinner than the radius, and at 72 and 130 rows (a part chunk
    on axes 0 and 1; 130 and 2 take the scalar rows path on axis 2)."""
    for n_loc in (2, 16, 72, 130):
        shape = list(SHAPE)
        shape[axis] = n_loc + 8
        f = _randn((3,) + tuple(shape), 9, cuda)
        got = P.stencil_valid(f, axis, FD8.FD8_COEFFS, 0.7)
        ref = P.stencil_valid_plain(f, axis, FD8.FD8_COEFFS, 0.7)
        assert got.shape == ref.shape and got.shape[1 + axis] == n_loc
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("weight_dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("method", I.METHODS)
@pytest.mark.parametrize("kind", QUERY_SETS)
def test_k2_matches_plain(cuda, method, kind, weight_dtype):
    """K = 1, 2, 3 fields."""
    shape, q = _query_set(kind, cuda, seed=1)
    plan = I.build_plan(q, method, weight_dtype, shape=shape)
    for lead in ((), (2,), (3,)):
        coef = _randn(lead + shape, 2, cuda)
        _assert_scaled(K.apply_plan(coef, plan), K.apply_plan_plain(coef, plan))


@pytest.mark.parametrize("weight_dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("epilogue", sorted(K.EPILOGUES))
@pytest.mark.parametrize("method", ["cubic_bspline", "linear"])
@pytest.mark.parametrize("kind", QUERY_SETS)
def test_k3_matches_plain(cuda, kind, method, epilogue, weight_dtype):
    """At every query set K2 is checked at, S = 4 and 2."""
    shape, q = _query_set(kind, cuda, seed=1)
    plan = I.build_plan(q, method, weight_dtype, shape=shape)
    coefs = _randn((2,) + shape, 3, cuda)
    extra = _randn(tuple(q.shape[1:]), 4, cuda)
    _assert_scaled(K.apply_plan_fused(coefs, plan, extra, epilogue, 0.25),
                   K.apply_plan_fused_plain(coefs, plan, extra, epilogue, 0.25))


@pytest.mark.parametrize("weight_dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("method", ["cubic_bspline", "linear"])
def test_k2_k3_on_a_halo_extended_field(cuda, method, weight_dtype):
    """The slab solve's plans: a field with 2 x 6 halo rows on x1 (clamped),
    gathered at its 20 x 16 x 32 interior, so the output shape is not the
    field shape."""
    halo, interior = 6, (20,) + SHAPE[1:]
    field = (interior[0] + 2 * halo,) + interior[1:]
    _, q = _query_set("near", cuda, seed=5)
    q = q[:, :interior[0]].clone()
    q[0] += halo
    plan = I.build_plan(q, method, weight_dtype, shape=field, wrap=(False, True, True))
    coefs = _randn((2,) + field, 6, cuda)
    extra = _randn(interior, 7, cuda)
    _assert_scaled(K.apply_plan(coefs, plan), K.apply_plan_plain(coefs, plan))
    for epilogue in sorted(K.EPILOGUES):
        _assert_scaled(K.apply_plan_fused(coefs, plan, extra, epilogue, 0.25),
                       K.apply_plan_fused_plain(coefs, plan, extra, epilogue, 0.25))


@pytest.mark.parametrize("weight_dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("basis", I.METHODS)
@pytest.mark.parametrize("kind", QUERY_SETS)
def test_k4_matches_plain(cuda, basis, kind, weight_dtype):
    """K = 1, 2, 3 fields, queries inside and past the Pallas bound. The cubic
    bases go through the shared-memory box and the global branch: every block
    of the near-identity sets stages its box, no block of the uniform set
    does, and at "wide-9.5" some blocks do and the others do not (as
    ``tests/test_torch_interp3d_tiles.py`` emulates it)."""
    shape, q = _query_set(kind, cuda)
    for lead in ((), (2,), (3,)):
        coef = _randn(lead + shape, 8, cuda)
        _assert_scaled(K.interp3d(coef, q, basis, weight_dtype),
                       K.interp3d_plain(coef, q, basis, weight_dtype))
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    K.interp3d(coef, q, basis, weight_dtype, box_blocks=counter)
    share = int(counter.item()) / K.tile_blocks(q.shape[1:], K.interp3d_tile(basis))
    if K.interp3d_tile(basis) != K.TILE_3D_BOX or kind == "uniform":
        assert share == 0.0
    elif kind == "wide-9.5":
        assert 0.0 < share < 1.0
    else:
        assert share == 1.0


def _plan_bits(idx, weights):
    """A plan's tensors as bit patterns: weights viewed as integers of their
    width, so that -0 against +0 and NaN payloads show."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return [t.clone() for t in idx] + [w.view(view[w.dtype]).clone() for w in weights]


def _assert_plan_bit_equal(q, method, weight_dtype, shape, wrap=(True, True, True)):
    """The kernel's plan against the plain build run on the same card."""
    got = I.build_plan(q, method, weight_dtype, shape=shape, wrap=wrap)
    ref = KP.build_plan_plain(q, method, weight_dtype, shape, wrap)
    assert [w.dtype for w in got.weights] == [w.dtype for w in ref[1]]
    for g, r in zip(_plan_bits(got.idx, got.weights), _plan_bits(*ref)):
        assert g.shape == r.shape and g.is_contiguous()
        assert torch.equal(g, r), f"{int((g != r).sum())} of {g.numel()} differ"


@pytest.mark.parametrize("wrap", [(True, True, True), (False, True, True)], ids=["TTT", "FTT"])
@pytest.mark.parametrize("weight_dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("method", I.METHODS)
@pytest.mark.parametrize("kind", QUERY_SETS)
def test_build_plan_kernel_matches_plain_bit_for_bit(cuda, kind, method, weight_dtype, wrap):
    shape, q = _query_set(kind, cuda, seed=3)
    _assert_plan_bit_equal(q, method, weight_dtype, shape, wrap)


@pytest.mark.parametrize("weight_dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("method", I.METHODS)
def test_build_plan_kernel_edge_queries(cuda, method, weight_dtype):
    """A halo-extended field (x1 clamped, the output its interior), queries
    exactly on integers (t = 0, also -0.0), and an output of 3 * 31 points
    (not a multiple of 4: the scalar path and its tail)."""
    halo, interior = 6, (20,) + SHAPE[1:]
    field = (interior[0] + 2 * halo,) + interior[1:]
    _, q = _query_set("near", cuda, seed=5)
    q = q[:, :interior[0]].clone()
    q[0] += halo
    _assert_plan_bit_equal(q, method, weight_dtype, field, (False, True, True))
    q_int = torch.floor(_queries(cuda, seed=6))
    q_int[:, 0] = -0.0
    _assert_plan_bit_equal(q_int, method, weight_dtype, SHAPE)
    _assert_plan_bit_equal(_queries(cuda, seed=7)[:, :3, :1, :31].contiguous(), method,
                           weight_dtype, SHAPE)


@pytest.mark.parametrize("weight_dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("method", I.METHODS)
def test_build_plan_kernel_at_256_footpoints(cuda, method, weight_dtype):
    """The main path's shape: RK2 footpoints of a smooth 256^3 velocity."""
    shape = (256, 256, 256)
    v = S.random_velocity(torch.Generator().manual_seed(0), shape, amplitude=0.6, device=cuda)
    foot = SL.trace_characteristic(v, 0.25, "cubic_bspline", 1.0)
    del v
    _assert_plan_bit_equal(foot, method, weight_dtype, shape)


def _plain_build(q, method, weight_dtype=None, shape=None, wrap=(True, True, True)):
    shape = tuple(int(n) for n in (shape if shape is not None else q.shape[1:]))
    return KP.build_plan_plain(q, method, weight_dtype, shape, wrap)


@pytest.mark.parametrize("kw", [dict(use_fused_matvec=True),
                                dict(use_plan=False, mixed_precision=True)],
                         ids=["fused_fp32", "planfree_bf16"])
def test_solve_with_kernel_plans_equals_solve_with_plain_plans(cuda, kw, monkeypatch):
    """A 32^3 solve takes the same Newton and PCG counts and ends at the
    same v, bit for bit, with the kernel's plans and with the plain build
    run on the card in its place."""
    pair = S.make_pair(0, (32, 32, 32), device=cuda)
    counts.reset()
    got = R.register(pair.m0, pair.m1, device=cuda, **kw)
    torch.cuda.synchronize()
    launched = counts.snapshot()
    monkeypatch.setattr(KP, "build_plan", _plain_build)
    ref = R.register(pair.m0, pair.m1, device=cuda, **kw)
    assert _counts(got) == _counts(ref) and got.matvecs == ref.matvecs
    assert torch.equal(got.v.view(torch.int32), ref.v.view(torch.int32))
    key = "build_plan:cubic_bspline" + (":bf16" if kw.get("mixed_precision") else "")
    assert launched.get(key, 0) > 0
    assert not [k for k in launched if k.startswith("plain:")]


def test_build_plan_launches_are_counted(cuda):
    q = _queries(cuda)
    counts.reset()
    for method in I.METHODS:
        for wd in (None, torch.bfloat16):
            I.build_plan(q, method, wd)
    torch.cuda.synchronize()
    assert counts.snapshot() == {f"build_plan:{m}{w}": 1 for m in I.METHODS
                                 for w in ("", ":bf16")}


def test_build_plan_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q = _queries(cuda)
    with pytest.raises(ValueError, match="contiguous float32"):
        I.build_plan(q.double(), "linear")
    with pytest.raises(ValueError, match="contiguous float32"):
        I.build_plan(q.transpose(1, 3), "linear")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        I.build_plan(q, "linear", torch.float16)


def _contract_inputs(dev, nt, shape, seed, misalign=False):
    """vt, the trajectory gradients, the nt + 1 adjoint fields and an a term;
    ``misalign``: the second adjoint field one element off 16-byte alignment."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*dims):
        return torch.randn(dims + shape, generator=gen, device=dev)

    vt, grad, a = rnd(3), rnd(nt + 1, 3), rnd(3)
    lam = list(rnd(nt + 1))
    if misalign:
        lam[1] = torch.randn(math.prod(shape) + 1, generator=gen, device=dev)[1:].view(shape)
    return vt, grad, lam, a


def _bits_equal(got, ref):
    return got.shape == ref.shape and torch.equal(got.view(torch.int32), ref.view(torch.int32))


#: (nt, field shape, misaligned adjoint field): the main path's shape, a
#: small grid, nt + 1 unrolled (1, 6) and in a loop (12), and the scalar
#: path (an odd grid, a misaligned field)
CONTRACT_CASES = {"256^3": (4, (256, 256, 256), False), "32^3": (4, (32, 32, 32), False),
                  "nt1": (1, (32, 32, 32), False), "nt6": (6, (32, 32, 32), False),
                  "nt12_loop": (12, (32, 32, 32), False), "odd": (4, (33, 17, 5), False),
                  "misaligned": (4, (32, 32, 32), True)}


@pytest.mark.parametrize("case", sorted(CONTRACT_CASES))
def test_contraction_kernels_match_plain_bit_for_bit(cuda, case):
    nt, shape, misalign = CONTRACT_CASES[case]
    vt, grad, lam, a = _contract_inputs(cuda, nt, shape, 3, misalign)
    counts.reset()
    assert _bits_equal(KC.traj_sources(vt, grad), KC.traj_sources_plain(vt, grad))
    for a_term in (None, a):
        assert _bits_equal(KC.traj_body_force(lam, grad, 1.0 / nt, a=a_term),
                           KC.traj_body_force_plain(lam, grad, 1.0 / nt, a_term))
    torch.cuda.synchronize()
    assert counts.snapshot() == {"traj_source": 1, "traj_body_force": 2}


@pytest.mark.parametrize("kw", [dict(use_fused_matvec=True),
                                dict(use_plan=False, mixed_precision=True)],
                         ids=["fused_fp32", "planfree_bf16"])
def test_contractions_launch_once_a_matvec_and_a_gradient(cuda, kw, monkeypatch):
    """A 32^3 registration: one launch of each contraction every matvec, one
    body force every gradient evaluation, and no plain version."""
    calls = {"matvec": 0, "gradient": 0}

    def spy(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(HS, "matvec", spy("matvec", HS.matvec))
    monkeypatch.setattr(GR, "evaluate", spy("gradient", GR.evaluate))
    pair = S.make_pair(0, (32, 32, 32), device=cuda)
    counts.reset()
    res = R.register(pair.m0, pair.m1, device=cuda, **kw)
    torch.cuda.synchronize()
    launched = counts.snapshot()
    assert calls["matvec"] == res.matvecs > 0 and calls["gradient"] > 0
    assert launched["traj_source"] == calls["matvec"]
    assert launched["traj_body_force"] == calls["matvec"] + calls["gradient"]
    assert not [k for k in launched if k.startswith("plain:")]


@pytest.mark.parametrize("kw", [dict(use_fused_matvec=True),
                                dict(use_plan=False, mixed_precision=True)],
                         ids=["fused_fp32", "planfree_bf16"])
def test_solve_with_contraction_kernels_equals_solve_with_plain_versions(cuda, kw,
                                                                         monkeypatch):
    """A 32^3 solve takes the same counts and ends at the same v, bit for
    bit, with the kernels and with their plain versions run on the card."""
    pair = S.make_pair(0, (32, 32, 32), device=cuda)
    got = R.register(pair.m0, pair.m1, device=cuda, **kw)
    monkeypatch.setattr(KC, "traj_sources", KC.traj_sources_plain)
    monkeypatch.setattr(KC, "traj_body_force", KC.traj_body_force_plain)
    ref = R.register(pair.m0, pair.m1, device=cuda, **kw)
    assert _counts(got) == _counts(ref) and got.matvecs == ref.matvecs
    assert torch.equal(got.v.view(torch.int32), ref.v.view(torch.int32))


def test_contraction_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    vt, grad, lam, a = _contract_inputs(cuda, 4, (8, 8, 8), 0)
    with pytest.raises(ValueError, match="contiguous float32"):
        KC.traj_sources(vt.double(), grad.double())
    with pytest.raises(ValueError, match="contiguous float32"):
        KC.traj_body_force([x.transpose(0, 2) for x in lam], grad, 0.25)
    with pytest.raises(ValueError, match="contiguous float32"):
        KC.traj_body_force(lam, grad, 0.25, a=a.transpose(1, 3))
    with pytest.raises(ValueError, match="time slices"):
        KC.traj_sources(vt, torch.zeros((KC.MAX_SLICES + 1, 3, 8, 8, 8), device=cuda))


def test_k4_on_two_cards(cuda):
    """K4 cubic on a second card after the first: each launch sets the
    kernel's shared-memory attribute in the current card's context."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    q = _queries(torch.device("cpu"), seed=7)
    coef = _randn(SHAPE, 8, torch.device("cpu"))
    for basis in ("cubic_bspline", "linear"):
        ref = K.interp3d_plain(coef, q, basis)
        for dev in ("cuda:0", "cuda:1", "cuda:0"):
            got = K.interp3d(coef.to(dev), q.to(dev), basis)
            _assert_scaled(got.cpu(), ref)


def test_k1_k5_k6_on_two_cards(cuda):
    """K1 (FD8 and the prefilter), K5 and K6 (bf16, hd 64) on a second card
    after the first, and back: each wrapper launches in its input's card's
    context, with that card's stream."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    cpu = torch.device("cpu")
    f = _randn((2,) + SHAPE, 12, cpu)
    f_ext = _randn((3, 2 + 8) + SHAPE[1:], 13, cpu)
    qkv = tuple(_randn((3, 200, 64), 50 + i, cpu).bfloat16() for i in range(3))
    scale = 1.0 / (2 * math.pi / SHAPE[0])
    refs = {
        "fd8": P.stencil_axis_plain(f, 0, FD8.FD8_COEFFS, False, scale),
        "prefilter": P.stencil_axis_plain(f, 1, PF.PREFILTER_TAPS, True, 1.0),
        "k5": P.stencil_valid_plain(f_ext, 0, FD8.FD8_COEFFS, scale),
        "k6": FA.flash_attention_plain(*qkv, True),
    }
    for dev in ("cuda:0", "cuda:1", "cuda:0"):
        got = {
            "fd8": P.stencil_axis(f.to(dev), 0, FD8.FD8_COEFFS, False, scale),
            "prefilter": P.stencil_axis(f.to(dev), 1, PF.PREFILTER_TAPS, True, 1.0),
            "k5": P.stencil_valid(f_ext.to(dev), 0, FD8.FD8_COEFFS, scale),
            "k6": FA.flash_attention(*(t.to(dev) for t in qkv), True),
        }
        torch.cuda.synchronize(dev)
        for key in ("fd8", "prefilter", "k5"):
            assert got[key].device == torch.device(dev)
            torch.testing.assert_close(got[key].cpu(), refs[key], rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(got["k6"].cpu().float(), refs["k6"].float(),
                                   **K6_TOL[torch.bfloat16])
        assert float((got["k6"].cpu() != refs["k6"]).float().mean()) <= K6_BF16_DIFFER


def test_wrappers_raise_on_what_kernels_do_not_take(cuda):
    f = _randn(SHAPE, 5, cuda)
    with pytest.raises(TypeError):
        P.stencil_axis(f.double(), 0, FD8.FD8_COEFFS, False)
    with pytest.raises(ValueError, match="contiguous"):
        P.stencil_axis(f.transpose(0, 2), 0, FD8.FD8_COEFFS, False)
    plan = _plan(cuda, "cubic_bspline")
    # bf16 weights run (they raised before they were ported) and match plain
    bf16 = I.InterpPlan(plan.idx, tuple(w.bfloat16() for w in plan.weights),
                        plan.method, plan.field_shape)
    _assert_scaled(K.apply_plan(f, bf16), K.apply_plan_plain(f, bf16))
    half = I.InterpPlan(plan.idx, tuple(w.half() for w in plan.weights),
                        plan.method, plan.field_shape)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.apply_plan(f, half)
    with pytest.raises(TypeError):
        K.apply_plan(f.double(), plan)
    q = _queries(cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K.interp3d(f, q, "linear", torch.float16)
    with pytest.raises(ValueError, match="query points"):
        K.interp3d(f, q.double(), "linear")


def test_launches_are_counted_and_no_plain_version_runs(cuda):
    f = _randn((2,) + SHAPE, 6, cuda)
    plan = _plan(cuda, "cubic_bspline")
    counts.reset()
    K.apply_plan_fused(PF.prefilter3d(f), plan, f[0], "inc_state", 0.25)
    K.apply_plan(f, plan)
    FD8.fd8_grad(f[0])
    torch.cuda.synchronize()
    K.interp3d(f, _queries(cuda), "cubic_lagrange", torch.bfloat16)
    torch.cuda.synchronize()
    assert counts.snapshot() == {"stencil_axis:prefilter": 3, "apply_plan_fused:inc_state": 1,
                                 "apply_plan": 1, "stencil_axis:fd8": 3,
                                 "interp3d:cubic_lagrange:bf16": 1}


def test_register_on_card_matches_cpu(cuda):
    pair = S.make_pair(0, (16, 16, 16), device="cpu")
    ref = R.register(pair.m0, pair.m1, device="cpu")
    got = R.register(pair.m0, pair.m1, use_fused_matvec=True, device=cuda)
    assert got.iters == ref.iters and got.converged == ref.converged
    assert [h["pcg_iters"] for h in got.history] == [h["pcg_iters"] for h in ref.history]
    assert float((got.v.cpu() - ref.v).abs().max()) <= 1e-4 * float(ref.v.abs().max())


def test_planfree_registers_on_card_as_on_cpu(cuda):
    """Plan-free fp32: equal counts; plan-free with bf16 weights: Newton
    iterations within 1 (bf16 roundings follow the fp32 values below them,
    which the card sums in another order)."""
    pair = S.make_pair(0, (16, 16, 16), device="cpu")
    for mixed in (False, True):
        ref = R.register(pair.m0, pair.m1, use_plan=False, mixed_precision=mixed,
                         device="cpu")
        got = R.register(pair.m0, pair.m1, use_plan=False, mixed_precision=mixed,
                         device=cuda)
        if mixed:
            assert abs(got.iters - ref.iters) <= 1 and got.detF["min"] > 0
        else:
            assert got.iters == ref.iters
            assert ([h["pcg_iters"] for h in got.history]
                    == [h["pcg_iters"] for h in ref.history])
            assert float((got.v.cpu() - ref.v).abs().max()) <= 1e-4 * float(ref.v.abs().max())


def test_register_sharded_on_a_one_rank_nccl_group_matches_register(cuda, tmp_path):
    """The slab path on the card: one NCCL rank (all-gather exchanges, K5 on
    the halo-extended slab, plans on the extended frame) against the
    single-device solve on the same card."""
    pair = S.make_pair(0, (32, 32, 32), device=cuda)
    ref = R.register(pair.m0, pair.m1, use_fused_matvec=True, device=cuda)
    G.init_slab_group(0, 1, f"file://{tmp_path}/store", "cuda")
    try:
        counts.reset()
        got = R.register_sharded(pair.m0, pair.m1, use_fused_matvec=True, device=cuda)
        torch.cuda.synchronize()
        launched = counts.snapshot()
    finally:
        dist.destroy_process_group()
    assert got.iters == ref.iters
    assert [h["pcg_iters"] for h in got.history] == [h["pcg_iters"] for h in ref.history]
    assert float((got.v - ref.v).abs().max()) <= 1e-4 * float(ref.v.abs().max())
    assert launched.get("stencil_valid:fd8", 0) > 0
    assert launched.get("apply_plan_fused:inc_state", 0) > 0
    assert not [k for k in launched if k.startswith("plain:")]


def _counts(res):
    return res.iters, [h["pcg_iters"] for h in res.history], res.converged


@pytest.mark.parametrize("measure,max_newton,v_rel", [("ncc", 50, 1e-4), ("ngf", 4, 1e-2)])
def test_measures_register_on_card_as_on_cpu(cuda, measure, max_newton, v_rel):
    """NCC and NGF on the contrast-inverted 16^3 pair, fused matvec: equal
    Newton and PCG counts, v within 1e-4 * max|v| (NCC). NGF is capped at
    four steps (in its sixth and seventh PCG runs to its 500-iteration cap,
    in the JAX package as in the port), and
    its v is held within 1e-2 * max|v|: its GN density divides by
    (|grad m|^2 + eps^2)^2, and the JAX package and the port, both on the
    CPU, differ by 2.8e-3 * max|v| after four steps at equal counts."""
    pair = S.make_multimodal_pair(0, (16, 16, 16), mode="inverted", device="cpu")
    kw = dict(measure=measure, use_fused_matvec=True, max_newton=max_newton)
    ref = R.register(pair.m0, pair.m1, device="cpu", **kw)
    counts.reset()
    got = R.register(pair.m0, pair.m1, device=cuda, **kw)
    torch.cuda.synchronize()
    launched = counts.snapshot()
    assert _counts(got) == _counts(ref)
    assert float((got.v.cpu() - ref.v).abs().max()) <= v_rel * float(ref.v.abs().max())
    assert launched.get("apply_plan_fused:inc_state", 0) > 0
    assert not [k for k in launched if k.startswith("plain:")]
    if measure == "ngf":
        assert launched["stencil_axis:fd8"] >= 6 * got.matvecs


def test_register_batch_on_card_matches_cpu(cuda):
    """A B = 2 batch with the donating step on the card against the host
    test on the CPU: per-pair counts equal, v within 1e-4 * max|v|; pair 0
    equals the card's own ``register`` of that pair."""
    batch = S.make_batch(0, (16, 16, 16), 2, device="cpu")
    ref = R.register_batch(batch.m0, batch.m1, use_fused_matvec=True, device="cpu")
    got = R.register_batch(batch.m0, batch.m1, use_fused_matvec=True, donate=True,
                           device=cuda)
    assert got.iters == ref.iters and got.matvecs == ref.matvecs
    assert got.converged == ref.converged
    assert float((got.v.cpu() - ref.v).abs().max()) <= 1e-4 * float(ref.v.abs().max())
    single = R.register(batch.m0[0], batch.m1[0], use_fused_matvec=True, device=cuda)
    assert single.iters == got.iters[0] and single.matvecs == got.matvecs[0]
    assert float((got.v[0] - single.v).abs().max()) <= 1e-6 * float(single.v.abs().max())


def _serve_rounds(device, m0, m1, cache_dir):
    """Pairs 0 and 1 cold, then both again (warm), through one server."""
    config = SV.ServeConfig(max_batch=2, use_fused_matvec=True, cache_dir=str(cache_dir),
                            device=device)
    out = []
    with SV.Server(config) as srv:
        for _ in range(2):
            futs = [srv.submit(SV.Request(m0=m0[i], m1=m1[i], subject=f"s{i}"))
                    for i in range(2)]
            out += [f.result(timeout=600) for f in futs]
    return out, srv.summary()


def test_server_on_card_matches_cpu(cuda, tmp_path):
    """The registration server at 16^3 on the card (donating batch step,
    fused matvec, checkpointed cache) against the same server on the CPU,
    over a cold and a warm round: equal counts and warm starts, v within
    1e-4 * max|v|; K1, K2 and K3 launched and no plain version ran."""
    batch = S.make_batch(0, (16, 16, 16), 2, device="cpu")
    ref, s_ref = _serve_rounds("cpu", batch.m0, batch.m1, tmp_path / "cpu")
    counts.reset()
    got, s_got = _serve_rounds("cuda", batch.m0.numpy(), batch.m1.numpy(), tmp_path / "cuda")
    launched = counts.snapshot()
    for a, b in zip(got, ref):
        assert (a.iters, a.matvecs, a.converged, a.warm_started, a.cache_visits) == \
            (b.iters, b.matvecs, b.converged, b.warm_started, b.cache_visits)
        assert float(abs(a.v - b.v).max()) <= 1e-4 * float(abs(b.v).max())
    assert [r.warm_started for r in got] == [False, False, True, True]
    assert s_got["failed"] == 0 and s_got["completed"] == 4 and s_got["warm_hits"] == 2
    for key in ("stencil_axis:fd8", "stencil_axis:prefilter", "apply_plan",
                "apply_plan_fused:inc_state", "apply_plan_fused:inc_adjoint"):
        assert launched.get(key, 0) > 0, key
    assert not [k for k in launched if k.startswith("plain:")]
    assert CK.latest_step(str(tmp_path / "cuda" / "s0")) == 2


def test_bf16_checkpoint_round_trip_on_card(cuda, tmp_path):
    x = _randn((3, 5, 7), 40, cuda).to(torch.bfloat16)
    CK.save_checkpoint(str(tmp_path), {"x": x, "n": {"y": x[0]}}, step=1)
    out = CK.restore_checkpoint(str(tmp_path), {"x": x, "n": {"y": x[0]}}, device="cuda")
    assert out["x"].device.type == "cuda" and out["x"].dtype == torch.bfloat16
    assert torch.equal(out["x"].view(torch.int16), x.view(torch.int16))
    assert torch.equal(out["n"]["y"].view(torch.int16), x[0].view(torch.int16))
    host = CK.restore_checkpoint(str(tmp_path), {"x": x.cpu()})
    assert host["x"].device.type == "cpu"


K6_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4), torch.bfloat16: dict(rtol=8e-3, atol=1e-4)}
K6_BF16_DIFFER = 0.05


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hd,s", [(64, 256), (64, 200), (128, 130), (128, 64)])
def test_k6_matches_plain(cuda, hd, s, dtype, causal):
    """Full and ragged sequence lengths (S = 200 and 130 end in a part
    tile), both head sizes."""
    q, k, v = (_randn((6, s, hd), 20 + i, cuda).to(dtype) for i in range(3))
    got = FA.flash_attention(q, k, v, causal)
    assert got.dtype == dtype and got.shape == q.shape
    ref = FA.flash_attention_plain(q, k, v, causal)
    torch.testing.assert_close(got.float(), ref.float(), **K6_TOL[dtype])
    if dtype == torch.bfloat16:
        assert float((got != ref).float().mean()) <= K6_BF16_DIFFER


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s", [1, 37, 64, 2000, 4097])
def test_k6_bf16_tensor_core_shapes(cuda, s, hd, causal):
    """The bf16 tensor-core kernel at one query row, part tiles (37, 2000,
    4097 = 64 tiles + 1 row) and one whole tile, against K6's bf16 check."""
    bh = 3 if s <= 2000 else 2
    q, k, v = (_randn((bh, s, hd), 40 + i, cuda).bfloat16() for i in range(3))
    got = FA.flash_attention(q, k, v, causal)
    ref = FA.flash_attention_plain(q, k, v, causal)
    torch.testing.assert_close(got.float(), ref.float(), **K6_TOL[torch.bfloat16])
    assert float((got != ref).float().mean()) <= K6_BF16_DIFFER


def test_k6_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q = _randn((2, 64, 64), 30, cuda)
    for bad, err in (((q[..., :32].contiguous(),) * 3, "head size"),
                     ((q.transpose(0, 1),) * 3, "contiguous"),
                     ((q, q.bfloat16(), q), "one dtype"),
                     ((q.bfloat16().reshape(-1)[4:4 + 127 * 64].view(1, 127, 64),) * 3,
                      "aligned")):
        with pytest.raises((ValueError, TypeError), match=err):
            FA.flash_attention(*bad)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "smollm-135m"])
def test_smoke_serve_on_card_matches_cpu(cuda, arch):
    """The smoke config with K6's head size 64, fp32, the same seeded
    weights on the card and on the CPU: equal greedy ids, prefill logits
    within 1e-4 * max|logits|, one K6 launch per layer and no plain version."""
    cfg = dataclasses.replace(ARCHS[arch].smoke(), head_dim=64, param_dtype="float32",
                              compute_dtype="float32")
    tok = torch.randint(0, cfg.vocab_size, (3, 100), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok}
    ref = serve_lm.serve(build_model(cfg, "cpu").init(torch.Generator().manual_seed(0)), batch,
                         6)
    model = build_model(cfg, cuda).init(torch.Generator().manual_seed(0))
    counts.reset()
    got = serve_lm.serve(model, batch, 6)
    assert counts.snapshot() == {"flash_attention": cfg.n_layers}
    assert torch.equal(got.ids.cpu(), ref.ids)
    want = ref.prefill_logits
    assert float((got.prefill_logits.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())


#: K6 at the prefill shapes of the non-dense LM paths (bf16): deepseek's hd
#: 128 MHA, jamba's GQA heads after the K/V repeat, internvl2's 256 + 1792
#: positions, whisper's ragged non-causal encoder (1500 frames) and causal
#: decoder (187 tokens).
K6_LM_SHAPES = {"deepseek": (128, 2048, 128, True), "jamba": (256, 2048, 128, True),
                "internvl2": (112, 2048, 64, True), "whisper-enc": (160, 1500, 64, False),
                "whisper-dec": (160, 187, 64, True)}


@pytest.mark.parametrize("case", sorted(K6_LM_SHAPES))
def test_k6_lm_family_shapes(cuda, case):
    bh, s, hd, causal = K6_LM_SHAPES[case]
    q, k, v = (_randn((bh, s, hd), 50 + i, cuda).bfloat16() for i in range(3))
    counts.reset()
    got = FA.flash_attention(q, k, v, causal)
    assert counts.snapshot() == {"flash_attention": 1}
    ref = FA.flash_attention_plain(q, k, v, causal)
    torch.testing.assert_close(got.float(), ref.float(), **K6_TOL[torch.bfloat16])
    assert float((got != ref).float().mean()) <= K6_BF16_DIFFER


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-780m", "jamba-v0.1-52b",
                                  "whisper-large-v3", "internvl2-1b"])
def test_smoke_family_serve_on_card_matches_cpu(cuda, arch):
    """Each non-dense family's smoke config (head size 64 for K6), fp32, the
    same seeded weights and batch on the card and on the CPU: equal greedy
    ids, prefill logits within 1e-4 * max|logits|, equal MoE routing, K6
    once per self-attention layer (the encoder's too) and no plain version."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(ARCHS[arch].smoke(), param_dtype="float32",
                              compute_dtype="float32")
    if cfg.n_heads:
        cfg = dataclasses.replace(cfg, head_dim=64)
    models = [build_model(cfg, d).init(torch.Generator().manual_seed(0)) for d in ("cpu", cuda)]
    batch = models[0].make_batch(torch.Generator().manual_seed(1),
                                 ShapeConfig("s", 64, 2, "prefill"))["batch"]
    routes, res = [], []
    route = MOE.route

    def spy(*args, **kwargs):
        routes[-1].append(route(*args, **kwargs))
        return routes[-1][-1]

    MOE.route = spy
    try:
        for m in models:
            routes.append([])
            counts.reset()
            res.append(serve_lm.serve(m, batch, 4))
    finally:
        MOE.route = route
    k6 = sum(n * sum(mx == "attn" for mx, _ in sigs) for n, sigs in T.segments(cfg))
    k6 += cfg.n_enc_layers if cfg.is_encdec else 0
    assert counts.snapshot() == ({"flash_attention": k6} if k6 else {})
    assert torch.equal(res[1].ids.cpu(), res[0].ids)
    want = res[0].prefill_logits
    assert float((res[1].prefill_logits.cpu() - want).abs().max()) <= \
        1e-4 * float(want.abs().max())
    assert len(routes[1]) == len(routes[0]) == (bool(cfg.n_experts) * len(routes[0]))
    for rc, r in zip(routes[1], routes[0]):
        assert torch.equal(rc.top_idx.cpu(), r.top_idx) and torch.equal(rc.keep.cpu(), r.keep)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b", "mamba2-780m",
                                  "jamba-v0.1-52b", "whisper-large-v3", "internvl2-1b"])
def test_smoke_family_train_step_on_card_matches_cpu(cuda, arch, monkeypatch):
    """One fp32 train step of each family's smoke config on the card and on
    the CPU, from the same seeded weights and batch (chip_smoke.py's
    train_parity): loss rtol 1e-5; the grad norm and every gradient leaf
    within 1e-4 (of the norm, of max|CPU leaf|); the card's new params and
    AdamW state within 1e-6 * |x| + 1e-6 * max|leaf| of the CPU's
    ``adamw_update`` of the card's gradients (not of the CPU's own step:
    Adam's first move is sign(g) * lr, and a gradient element within the
    gradient tolerance of 0 may step either way); no kernel launched."""
    from repro_torch.launch import train as TL
    from repro_torch.optim import adamw as OPT
    from repro_torch.train import steps as TS

    cfg = dataclasses.replace(ARCHS[arch].smoke(), param_dtype="float32",
                              compute_dtype="float32")
    ocfg = OPT.AdamWConfig(lr=3e-4, total_steps=6, warmup_steps=1)
    seen = []
    update = TS.adamw.adamw_update
    monkeypatch.setattr(TS.adamw, "adamw_update",
                        lambda c, g, o, p, **kw: seen.append(g) or update(c, g, o, p, **kw))
    runs = []
    for d in ("cpu", cuda):
        model = build_model(cfg, d)
        state = TS.init_train_state(model, torch.Generator().manual_seed(0), ocfg)
        batch = next(TL.token_batches(model, 64, 2, seed=0))
        counts.reset()
        runs.append((state,) + TS.make_train_step(model, None, ocfg)(state, batch))
    assert counts.snapshot() == {}
    (s0, _, m0), (_, n1, m1) = runs
    assert abs(float(m1["loss"]) - float(m0["loss"])) <= 1e-5 * abs(float(m0["loss"]))
    assert abs(float(m1["grad_norm"]) - float(m0["grad_norm"])) <= 1e-4 * float(m0["grad_norm"])
    g0, g1 = OPT.leaves(seen[0]), [t.cpu() for t in OPT.leaves(seen[1])]
    for a, b in zip(g1, g0):
        assert float((a.float() - b.float()).abs().max()) <= 1e-4 * float(b.abs().max())
    ref_p, ref_o, _ = OPT.adamw_update(ocfg, OPT.unflatten(seen[0], g1), s0.opt, s0.params)
    for got, ref in [(n1.params, ref_p)] + [(n1.opt[k], ref_o[k]) for k in ("m", "v", "master")]:
        for g, r in zip(OPT.leaves(got), OPT.leaves(ref)):
            torch.testing.assert_close(g.cpu(), r, rtol=1e-6, atol=1e-6 * float(r.abs().max()))


def _sharded_ranks(rank, n, init, out_dir):
    """One NCCL rank (its own card) of ``test_sharded_train_step_on_nccl_ranks``:
    two fp32 steps of the smollm and deepseek smoke configs on each mesh
    (tensor- and sequence-parallel over ``model``); rank 0 holds each step
    against its card's single-device loss and gradients and the
    ``adamw_update`` of the reduced gradients, gathered over ``model``, with
    the step's grad norm."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as ML
    from repro_torch.optim import adamw as OPT
    from repro_torch.train import steps as TS

    G.init_slab_group(rank, n, init, "cuda")
    try:
        meshes = [((n, 1), ("data", "model")), ((1, n), ("data", "model"))]
        if n % 2 == 0:
            meshes += [((2, n // 2), ("data", "model")), ((2, n // 2, 1), ("pod", "data", "model"))]
        ocfg = OPT.AdamWConfig(lr=3e-4, total_steps=6, warmup_steps=1)
        report = []
        for arch, seq in (("smollm-135m", 64), ("deepseek-moe-16b", 128)):
            cfg = dataclasses.replace(ARCHS[arch].smoke(), param_dtype="float32",
                                      compute_dtype="float32")
            model = build_model(cfg, "cuda")
            for shape, axes in meshes:
                mesh = ML.make_mesh(shape, axes, device="cuda")
                full = TS.init_train_state(model, torch.Generator().manual_seed(0), ocfg)
                specs = TS.state_specs(model, mesh)
                state = TS.shard_state(full, specs, mesh)
                seen, real = [], SH.mean_over
                SH.mean_over = lambda t, m, a: seen.append(real(t, m, a)) or seen[-1]
                try:
                    step = TS.make_train_step(model, mesh, ocfg)
                    gen = torch.Generator().manual_seed(1)
                    for _ in range(2):
                        batch = {k: torch.randint(0, 256, (2 * n, seq), generator=gen)
                                 for k in ("tokens", "targets")}
                        state, met = step(state, batch)
                        after = TS.gather_state(state, specs, mesh)
                        grads = [SH.gather(g, sp, mesh, axes=("model",)) for g, sp in zip(
                            seen[-1][:len(OPT.leaves(full.params))], OPT.leaves(specs.params))]
                        if rank == 0:
                            leaves = [p.detach().requires_grad_(True)
                                      for p in OPT.leaves(full.params)]
                            loss, _ = model.loss({k: v.cuda() for k, v in batch.items()},
                                                 OPT.unflatten(full.params, leaves))
                            single = torch.autograd.grad(loss, leaves)
                            ref_p, ref_o, _ = OPT.adamw_update(
                                ocfg, OPT.unflatten(full.params, grads), full.opt, full.params,
                                gnorm=met["grad_norm"])
                            report.append(dict(
                                arch=arch, mesh=shape,
                                loss_rel=abs(float(met["loss"]) - float(loss.detach()))
                                / float(loss.detach()),
                                grad_rel=max(float((g - s).abs().max()) / float(s.abs().max())
                                             for g, s in zip(grads, single)),
                                gnorm_rel=abs(float(met["grad_norm"])
                                              - float(OPT.global_norm(grads)))
                                / float(OPT.global_norm(grads)),
                                update_equal=all(torch.equal(a, b) for a, b in zip(
                                    OPT.leaves([after.params, after.opt]),
                                    OPT.leaves([ref_p, ref_o])))))
                        full = after
                finally:
                    SH.mean_over = real
        torch.save(report, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_sharded_train_step_on_nccl_ranks(cuda, tmp_path):
    """The sharded train step over one NCCL rank per card (all the cards):
    meshes (N, 1), (1, N), (2, N/2) and (2, N/2, 1) over pod, data, model,
    tensor- and sequence-parallel over ``model``; loss rtol 1e-5 and every
    reduced gradient leaf within 1e-4 * max|leaf| of the single-device step
    on the same card, the grad norm within rtol 1e-6 of theirs, the update
    bit-equal to ``adamw_update`` of the reduced gradients with the step's
    norm."""
    import torch.multiprocessing as mp

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards")
    mp.start_processes(_sharded_ranks, args=(n, f"file://{tmp_path}/store", str(tmp_path)),
                       nprocs=n, join=True, start_method="spawn")
    report = torch.load(tmp_path / "rank0.pt")
    assert len(report) == 2 * (4 if n % 2 == 0 else 2) * 2
    for r in report:
        assert r["loss_rel"] <= 1e-5 and r["grad_rel"] <= 1e-4 and r["update_equal"], r
        assert r["gnorm_rel"] <= 1e-6, r


def _serve_sharded_ranks(rank, n, init, out_dir):
    """One NCCL rank (its own card) of
    ``test_sharded_prefill_decode_on_nccl_ranks``: the sharded prefill and 4
    decode steps of the fp32 smollm, deepseek and mamba2 smoke configs on
    (1, N) and (2, N/2) into an fp32 cache (head size 64, K6's); rank 0 holds
    them against its card's unsharded ``prefill`` / ``decode_step`` on the
    same weights."""
    from repro_torch.launch import mesh as ML
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as OPT
    from repro_torch.train import steps as TS

    G.init_slab_group(rank, n, init, "cuda")
    try:
        meshes = [((1, n), ("data", "model"))]
        if n % 2 == 0 and n > 2:
            meshes.append(((2, n // 2), ("data", "model")))
        report = []
        for arch in ("smollm-135m", "deepseek-moe-16b", "mamba2-780m"):
            # head size 64: K6's
            cfg = dataclasses.replace(ARCHS[arch].smoke(), param_dtype="float32",
                                      compute_dtype="float32")
            if cfg.n_heads:
                cfg = dataclasses.replace(cfg, head_dim=64)
            model = build_model(cfg, "cuda")
            full = TS.init_train_state(model, torch.Generator().manual_seed(0)).params
            gen = torch.Generator().manual_seed(1)
            prompt = {"tokens": torch.randint(0, 256, (4, 128), generator=gen)}
            b, slots = (256 if cfg.n_experts else 8), 16
            toks = torch.randint(0, 256, (b, 4), generator=gen)
            f32 = torch.float32
            with torch.inference_mode():
                cache0 = T.make_stack_cache(cfg, b, slots, "cuda", dtype=f32)
                for t in OPT.leaves(cache0):
                    t.copy_(0.5 * torch.randn(t.shape, generator=gen))
                want_pre = model.prefill(prompt)
                ref_cache = T.make_stack_cache(cfg, b, slots, "cuda", dtype=f32)
                for x, y in zip(OPT.leaves(ref_cache), OPT.leaves(cache0)):
                    x.copy_(y)
                want = []
                for i in range(4):
                    lg, ref_cache = model.decode_step(ref_cache, toks[:, i:i + 1], 6 + i)
                    want.append(lg)
            for shape, axes in meshes:
                mesh = ML.make_mesh(shape, axes, device="cuda")
                params = TS.shard_params(full, mesh)
                pre = TS.make_prefill_step(model, mesh)(params, prompt)
                blocks = TS.shard_cache(T.make_stack_cache(cfg, b, slots, "cuda", dtype=f32),
                                        mesh)
                for x, y in zip(OPT.leaves(blocks), OPT.leaves(TS.shard_cache(cache0, mesh))):
                    x.copy_(y)
                dec = TS.make_decode_step(model, mesh, b, slots)
                got = []
                for i in range(4):
                    lg, blocks = dec(params, blocks, toks[:, i:i + 1], 6 + i)
                    got.append(lg)
                if rank == 0:
                    report.append(dict(arch=arch, mesh=shape, rel=max(
                        float((g - w).abs().max()) / float(w.abs().max())
                        for g, w in zip([pre] + got, [want_pre] + want)), ids=all(
                        torch.equal(g.argmax(-1), w.argmax(-1))
                        for g, w in zip([pre] + got, [want_pre] + want))))
        torch.save(report, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_sharded_prefill_decode_on_nccl_ranks(cuda, tmp_path):
    """The sharded prefill and decode steps over one NCCL rank per card (all
    the cards): K6 with the rank's query offset (smollm's 2 KV heads on 4
    cards), KV slots split over ``model`` and merged softmax, SSM heads
    split; logits within 1e-4 * max of the unsharded ones on the same card,
    equal greedy ids."""
    import torch.multiprocessing as mp

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards")
    mp.start_processes(_serve_sharded_ranks, args=(n, f"file://{tmp_path}/store",
                                                   str(tmp_path)),
                       nprocs=n, join=True, start_method="spawn")
    report = torch.load(tmp_path / "rank0.pt")
    assert len(report) == 3 * (2 if n % 2 == 0 and n > 2 else 1)
    for r in report:
        assert r["rel"] <= 1e-4 and r["ids"], r


def _compression_ranks(rank, n, init, out_dir):
    """One NCCL rank (its own card) of ``test_compressed_psum_pod_on_nccl_ranks``:
    ``compressed_psum_pod`` over the world of every rank's seeded gradients;
    rank 0 holds the result against the mean of every rank's dequantised
    payload, computed on its own card, and against the exact mean."""
    from repro_torch.distributed import compression as C

    G.init_slab_group(rank, n, init, "cuda")
    try:
        def grads_of(r):
            gen = torch.Generator().manual_seed(100 + r)
            return {"w": torch.randn((257, 96), generator=gen).cuda().to(torch.bfloat16),
                    "b": (1e-3 * torch.randn((3, 5), generator=gen)).cuda()}

        got = C.compressed_psum_pod(grads_of(rank), dist.group.WORLD)
        if rank == 0:
            every = [grads_of(r) for r in range(n)]
            report = {}
            for k, g in got.items():
                plain = torch.mean(torch.stack(
                    [C.dequantize_int8(*C.quantize_int8(e[k])) for e in every]), 0).to(g.dtype)
                exact = torch.mean(torch.stack([e[k].float() for e in every]), 0)
                report[k] = dict(equal=torch.equal(g, plain), dtype=g.dtype == every[0][k].dtype,
                                 rel=float((g.float() - exact).abs().max())
                                 / float(exact.abs().max()))
            torch.save(report, f"{out_dir}/rank0.pt")
    finally:
        dist.destroy_process_group()


def test_compressed_psum_pod_on_nccl_ranks(cuda, tmp_path):
    """The int8 cross-pod mean over one NCCL rank per card (all the cards):
    bit-equal to the mean of the ranks' dequantised payloads, the leaf's
    dtype kept, within JAX's 2e-2 * max|mean| of the exact mean."""
    import torch.multiprocessing as mp

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards")
    mp.start_processes(_compression_ranks, args=(n, f"file://{tmp_path}/store", str(tmp_path)),
                       nprocs=n, join=True, start_method="spawn")
    report = torch.load(tmp_path / "rank0.pt")
    assert set(report) == {"w", "b"}
    for r in report.values():
        assert r["equal"] and r["dtype"] and r["rel"] <= 2e-2, r

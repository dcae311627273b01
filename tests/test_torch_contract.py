"""The trajectory contractions' wrappers (``repro_torch.kernels.contract``)
on the CPU: the plain versions against the expressions the matvec, the
incremental state and the body force used before them, the solve's matvecs
and gradient through them, the fake route (the dry-run's shape inference)
and the wrappers' checks.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``
holds them to the plain versions there, bit for bit). The plain body force
sums the slices in time order, as ``transport.body_force``'s loop did; the
fused matvec's ``torch.sum`` over the stacked slices took the same order on
the CPU wherever a field's points are a multiple of 16 (every grid here; on
others the CPU's vectorised sum pairs the slices otherwise, an ulp apart).
"""

import math
import pathlib
import re

import pytest
import torch

from repro_torch.core import gradient as GR
from repro_torch.core import hessian as HS
from repro_torch.core import transport as TR
from repro_torch.core.registration import make_transport_config
from repro_torch.data import synthetic as S
from repro_torch.kernels import contract as C
from repro_torch.kernels import counts

SOURCE = pathlib.Path(C.__file__).resolve().parents[1] / "csrc" / "contract.cu"
BETA, GAMMA = 5e-4, 1e-4
SHAPES = [(16, 16, 16), (12, 16, 20)]
ODD = (9, 10, 12)


def _fields(nt1, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((3,) + shape, generator=gen),
            torch.randn((nt1, 3) + shape, generator=gen),
            list(torch.randn((nt1,) + shape, generator=gen)),
            torch.randn((3,) + shape, generator=gen))


def _weights(nt1, dt):
    w = torch.full((nt1,), dt)
    w[0] = 0.5 * dt
    w[-1] = 0.5 * dt
    return w


def _old_sources(vt, grad):
    """The sources of the fused matvec and the incremental state."""
    return -torch.sum(vt[None] * grad, dim=1)


def _old_fused_body(lam, grad, dt, a):
    """The fused matvec's body force and its regularisation term."""
    w = _weights(len(lam), dt)
    return a + torch.sum(w.reshape(-1, 1, 1, 1, 1) * torch.stack(list(lam))[:, None] * grad,
                         dim=0)


def _old_loop_body(lam, grad, dt, a=None):
    """``transport.body_force``'s loop; the gradient and the plan-free
    matvec added ``A v`` after it."""
    w = _weights(len(lam), dt)
    acc = torch.zeros(grad.shape[1:])
    for t in range(len(lam)):
        acc = acc + w[t] * lam[t][None] * grad[t]
    return acc if a is None else a + acc


def _bits_equal(got, ref):
    return got.shape == ref.shape and torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("shape", SHAPES + [ODD], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("nt", [1, 4, 6])
def test_plain_sources_are_the_old_expression(nt, shape):
    vt, grad, _, _ = _fields(nt + 1, shape, nt)
    counts.reset()
    got = C.traj_sources(vt, grad)
    assert counts.snapshot() == {"plain:traj_source": 1}
    assert _bits_equal(got, _old_sources(vt, grad))


@pytest.mark.parametrize("with_a", [False, True], ids=["body", "body+a"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("nt", [1, 4, 6])
def test_plain_body_force_is_both_old_expressions(nt, shape, with_a):
    _, grad, lam, a = _fields(nt + 1, shape, 10 + nt)
    a = a if with_a else None
    dt = 1.0 / nt
    counts.reset()
    got = C.traj_body_force(lam, grad, dt, a=a)
    assert counts.snapshot() == {"plain:traj_body_force": 1}
    assert _bits_equal(got, _old_loop_body(lam, grad, dt, a))
    if with_a:
        assert _bits_equal(got, _old_fused_body(lam, grad, dt, a))


@pytest.mark.parametrize("with_a", [False, True], ids=["body", "body+a"])
@pytest.mark.parametrize("nt", [1, 4, 6])
def test_plain_body_force_is_the_loop_on_an_odd_grid(nt, with_a):
    _, grad, lam, a = _fields(nt + 1, ODD, 20 + nt)
    a = a if with_a else None
    got = C.traj_body_force(torch.stack(lam).unbind(0), grad, 1.0 / nt, a=a)
    assert _bits_equal(got, _old_loop_body(lam, grad, 1.0 / nt, a))


def _state(shape, seed=3, **kw):
    cfg = make_transport_config("fd8-cubic", **kw)
    pair = S.make_pair(seed, shape, amplitude=0.5, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    v = S.random_velocity(gen, shape, amplitude=0.3)
    vt = S.random_velocity(gen, shape, amplitude=0.2)
    return cfg, pair, v, vt


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_matvec_is_the_one_before_the_kernels(shape, monkeypatch):
    """The fused matvec through the wrappers against the same matvec with
    the old expressions in their place; one of each plain version a matvec."""
    cfg, pair, v, vt = _state(shape, use_fused_matvec=True)
    gs = GR.evaluate(pair.m0, pair.m1, v, BETA, GAMMA, cfg)
    counts.reset()
    got = HS.matvec(vt, gs, v, BETA, GAMMA, cfg)
    assert counts.snapshot()["plain:traj_source"] == 1
    assert counts.snapshot()["plain:traj_body_force"] == 1
    monkeypatch.setattr(C, "traj_sources", _old_sources)
    monkeypatch.setattr(C, "traj_body_force", _old_fused_body)
    assert _bits_equal(got, HS.matvec(vt, gs, v, BETA, GAMMA, cfg))


@pytest.mark.parametrize("use_plan", [True, False], ids=["plan", "planfree"])
@pytest.mark.parametrize("shape", SHAPES + [ODD], ids=lambda s: "x".join(map(str, s)))
def test_loop_body_force_gradient_and_matvec_are_the_ones_before(shape, use_plan,
                                                                  monkeypatch):
    """``gradient.evaluate`` and the unfused matvec (the loop body force,
    ``A v`` added) through the wrappers against the old expressions."""
    cfg, pair, v, vt = _state(shape, use_plan=use_plan)
    counts.reset()
    gs = GR.evaluate(pair.m0, pair.m1, v, BETA, GAMMA, cfg)
    assert counts.snapshot().get("plain:traj_body_force") == 1
    assert (gs.grad_m_traj is not None) == use_plan
    counts.reset()
    hv = HS.matvec(vt, gs, v, BETA, GAMMA, cfg)
    assert counts.snapshot()["plain:traj_source"] == 1
    assert counts.snapshot()["plain:traj_body_force"] == 1
    monkeypatch.setattr(C, "traj_sources", _old_sources)
    monkeypatch.setattr(C, "traj_body_force", _old_loop_body)
    ref_gs = GR.evaluate(pair.m0, pair.m1, v, BETA, GAMMA, cfg)
    assert _bits_equal(gs.g, ref_gs.g)
    assert _bits_equal(hv, HS.matvec(vt, ref_gs, v, BETA, GAMMA, cfg))


def test_body_force_keeps_its_signature():
    """``transport.body_force`` without cached gradients computes them, as
    the JAX function does; ``regop()`` is added, folded into the kernel
    with cached gradients and after it without."""
    cfg, pair, v, _ = _state((8, 8, 8))
    m_traj = TR.solve_state(pair.m0, v, cfg)
    lam = TR.solve_adjoint(pair.m1 - m_traj[-1], v, cfg)
    body = TR.body_force(lam, m_traj, cfg)
    grad = TR.grad_traj(m_traj, cfg)
    assert _bits_equal(body, _old_loop_body(list(lam), grad, 0.25))
    a = torch.ones((3, 8, 8, 8))
    for cached in (grad, None):
        got = TR.body_force(lam, m_traj, cfg, grad_m_traj=cached, regop=lambda: a)
        assert _bits_equal(got, a + body)


def _fake(fn, *shapes, dtype=torch.float32):
    """``fn`` on fake tensors of ``shapes``: (output, launches, listener records)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    seen = []

    def listen(name, flops, nbytes, tensor_core):
        seen.append((name, flops, nbytes, tensor_core))

    counts.reset()
    counts.add_listener(listen)
    try:
        with FakeTensorMode():
            out = fn(*[torch.empty(s, dtype=dtype) for s in shapes])
    finally:
        counts.remove_listener(listen)
    launches = counts.snapshot()
    counts.reset()
    return out, launches, seen


@pytest.mark.parametrize("nt", [1, 4])
def test_fake_sources_count_one_launch_and_its_bytes(nt):
    shape = (6, 5, 7)
    m = math.prod(shape)
    out, launches, seen = _fake(C.traj_sources, (3,) + shape, (nt + 1, 3) + shape)
    assert tuple(out.shape) == (nt + 1,) + shape and out.dtype == torch.float32
    assert launches == {"fake:traj_source": 1}
    assert seen == [("traj_source", float(5 * (nt + 1) * m),
                     float(4 * m * (3 + 3 * (nt + 1) + (nt + 1))), False)]


@pytest.mark.parametrize("with_a", [False, True], ids=["body", "body+a"])
@pytest.mark.parametrize("nt", [1, 4])
def test_fake_body_force_counts_one_launch_and_its_bytes(nt, with_a):
    shape = (6, 5, 7)
    m = math.prod(shape)
    shapes = [(nt + 1, 3) + shape] + [shape] * (nt + 1) + ([(3,) + shape] if with_a else [])

    def call(grad, *rest):
        lam, a = (rest[:-1], rest[-1]) if with_a else (rest, None)
        return C.traj_body_force(lam, grad, 1.0 / nt, a=a)

    out, launches, seen = _fake(call, *shapes)
    assert tuple(out.shape) == (3,) + shape and out.dtype == torch.float32
    assert launches == {"fake:traj_body_force": 1}
    planes = 4 * (nt + 1) + 3 + (3 if with_a else 0)
    ops = 7 * (nt + 1) * m + (3 * m if with_a else 0)
    assert seen == [("traj_body_force", float(ops), float(4 * m * planes), False)]


def test_fake_matvec_launches_each_kernel_once():
    """The dry-run's fused matvec: one fake launch of each contraction."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, pair, v, vt = _state((8, 8, 8), use_fused_matvec=True)
    mode = FakeTensorMode(allow_non_fake_inputs=False)
    with mode:
        fm0, fm1, fv, fvt = (mode.from_tensor(t) for t in (pair.m0, pair.m1, v, vt))
        gs = GR.evaluate(fm0, fm1, fv, BETA, GAMMA, cfg)
        counts.reset()
        HS.matvec(fvt, gs, fv, BETA, GAMMA, cfg)
    launched = counts.snapshot()
    counts.reset()
    assert launched["fake:traj_source"] == 1 and launched["fake:traj_body_force"] == 1
    assert not [k for k in launched if k.startswith("plain:traj")]


@pytest.mark.parametrize("case", ["vt_components", "grad_rank", "grad_components", "vt_shape",
                                  "device"])
def test_sources_wrapper_raises_on_wrong_shapes(case):
    vt, grad, _, _ = _fields(5, (4, 4, 4), 0)
    args = {"vt_components": (vt[:2], grad), "grad_rank": (vt, grad[:, 0]),
            "grad_components": (vt, grad[:, :2]), "vt_shape": (vt[:, :3], grad),
            "device": (vt.to("meta"), grad)}[case]
    with pytest.raises(ValueError):
        C.traj_sources(*args)


@pytest.mark.parametrize("case", ["count", "lam_shape", "a_shape", "grad_components",
                                  "device"])
def test_body_force_wrapper_raises_on_wrong_shapes(case):
    _, grad, lam, a = _fields(5, (4, 4, 4), 1)
    args = dict(lam=lam, grad=grad, a=a)
    args.update({"count": dict(lam=lam[:4]), "lam_shape": dict(lam=[x[:3] for x in lam]),
                 "a_shape": dict(a=a[:2]), "grad_components": dict(grad=grad[:, :2]),
                 "device": dict(a=a.to("meta"))}[case])
    with pytest.raises(ValueError):
        C.traj_body_force(args["lam"], args["grad"], 0.25, a=args["a"])


@pytest.mark.parametrize("case", ["float64", "non_contiguous"])
def test_kernel_checks_raise_on_the_fake_route(case):
    shape = (4, 4, 4)
    if case == "float64":
        call = lambda: _fake(C.traj_sources, (3,) + shape, (5, 3) + shape,  # noqa: E731
                             dtype=torch.float64)
    else:
        call = lambda: _fake(lambda vt, g: C.traj_body_force(  # noqa: E731
            [x.transpose(0, 2) for x in g[:, 0]], g, 0.25), (3,) + shape, (5, 3) + shape)
    with pytest.raises(ValueError, match="contiguous float32"):
        call()


def test_wrapper_constants_are_the_sources():
    text = SOURCE.read_text()
    hit = re.search(r"constexpr int kMaxSlices = (\d+);", text)
    assert hit and int(hit.group(1)) == C.MAX_SLICES
    for name in ("traj_source_kernel", "traj_body_force_kernel"):
        assert f"{name}(" in text
        # the benchmark's kernel layers match on these: the kernels count as glue
        assert not re.search(r"(?i)fft|interp3d_kernel|apply_plan|stencil_", name)

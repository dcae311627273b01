"""The plan build's wrapper (``repro_torch.kernels.plan``) on the CPU: its
checks, the plain route and its count, the fake route (the dry-run's shape
inference), and a replay of ``build_plan_kernel``'s thread mapping and
index arithmetic (``csrc/plan.cu``) against the plain version.

The kernel itself runs only on the card (``tests/test_torch_gpu.py`` holds
it to the plain build there, bit for bit). What can be checked here is what
surrounds it: which elements each thread writes, with the constants read
from the source, and that the kernel's int32 wrap and clamp (C's ``%``
made non-negative, ``min``/``max``) are ``torch.remainder`` and
``torch.clamp`` at every query, negative ones and exact integers included.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.core import interp as I
from repro_torch.kernels import counts
from repro_torch.kernels import interp3d as K
from repro_torch.kernels import plan as KP

SOURCE = pathlib.Path(KP.__file__).resolve().parents[1] / "csrc" / "plan.cu"
WEIGHT_DTYPES = {"fp32": None, "bf16": torch.bfloat16}


def _cu_const(name: str) -> int:
    hit = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert hit, name
    return int(hit.group(1))


THREADS, POINTS = _cu_const("kThreads"), _cu_const("kPoints")


def _queries(shape, seed, spread=3.0, offset=0.0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.stack(torch.meshgrid(*[torch.arange(n, dtype=torch.float32) for n in shape],
                                   indexing="ij"))
    return x + offset + spread * (2 * torch.rand((3,) + shape, generator=gen) - 1)


@pytest.mark.parametrize("case", ["leading_dim", "rank", "method", "field_rank", "oversize",
                                  "device"])
def test_wrapper_checks_raise_on_every_route(case):
    q = _queries((4, 4, 4), 0)
    args = dict(q=q, method="cubic_bspline", shape=None)
    args.update({"leading_dim": dict(q=q[:2]), "rank": dict(q=q[:, 0, 0, 0]),
                 "method": dict(method="quintic"), "field_rank": dict(shape=(4, 16)),
                 "oversize": dict(shape=(2048, 1024, 1024)),
                 "device": dict(q=q.to("meta"))}[case])
    with pytest.raises(ValueError):
        I.build_plan(args["q"], args["method"], shape=args["shape"])


def _fake_build(q_shape, q_dtype=torch.float32, transpose=False, **kw):
    """``build_plan`` on fake query points: (plan, launches, listener records)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    seen = []

    def listen(name, flops, nbytes, tensor_core):
        seen.append((name, flops, nbytes, tensor_core))

    counts.reset()
    counts.add_listener(listen)
    try:
        with FakeTensorMode():
            q = torch.empty(q_shape, dtype=q_dtype)
            plan = I.build_plan(q.transpose(1, 2) if transpose else q, **kw)
    finally:
        counts.remove_listener(listen)
    launches = counts.snapshot()
    counts.reset()
    return plan, launches, seen


@pytest.mark.parametrize("case", ["float64", "non_contiguous", "float16_weights"])
def test_kernel_checks_raise_on_the_fake_route(case):
    kw = dict(method="linear")
    if case == "float64":
        exc, call = ValueError, lambda: _fake_build((3, 4, 4, 4), torch.float64, **kw)
    elif case == "non_contiguous":
        exc, call = ValueError, lambda: _fake_build((3, 4, 4, 4), transpose=True, **kw)
    else:
        exc, call = TypeError, lambda: _fake_build((3, 4, 4, 4), weight_dtype=torch.float16,
                                                   **kw)
    with pytest.raises(exc):
        call()


@pytest.mark.parametrize("out_shape,field", [((8, 8, 8), None), ((4, 8, 8), (16, 8, 8)),
                                             ((300,), (8, 8, 8))],
                         ids=["same", "halo_extended", "flat"])
@pytest.mark.parametrize("wd", sorted(WEIGHT_DTYPES))
@pytest.mark.parametrize("method", I.METHODS)
def test_fake_route_returns_the_plan_shapes_and_reports_its_bytes(method, wd, out_shape,
                                                                   field):
    weight_dtype = WEIGHT_DTYPES[wd]
    plan, launches, seen = _fake_build((3,) + out_shape, method=method,
                                       weight_dtype=weight_dtype, shape=field)
    support = K.BASES[method].support
    m = math.prod(out_shape)
    key = f"build_plan:{method}" + (":bf16" if weight_dtype else "")
    assert launches == {"fake:" + key: 1}
    assert plan.out_shape == out_shape and plan.support == support
    assert plan.field_shape == (field or out_shape)
    wbytes = 2 if weight_dtype else 4
    for t in plan.idx:
        assert t.shape == (support,) + out_shape and t.dtype == torch.int32
    for t in plan.weights:
        assert t.shape == (support,) + out_shape
        assert t.dtype == (weight_dtype or torch.float32) and t.is_contiguous()
    assert seen == [(key, float(m * K.QUERY_WEIGHT_OPS[method]),
                     float(3 * m * 4 + 3 * support * m * (4 + wbytes)), False)]


@pytest.mark.parametrize("wd", sorted(WEIGHT_DTYPES))
@pytest.mark.parametrize("method", I.METHODS)
def test_cpu_route_is_the_plain_build_and_counts_it(method, wd):
    weight_dtype = WEIGHT_DTYPES[wd]
    q = _queries((6, 5, 7), 1)
    counts.reset()
    plan = I.build_plan(q, method, weight_dtype)
    assert counts.snapshot() == {f"plain:build_plan:{method}" + (":bf16" if weight_dtype
                                                                  else ""): 1}
    counts.reset()
    idx, w = KP.build_plan_plain(q, method, weight_dtype, (6, 5, 7), (True, True, True))
    for a in range(3):
        assert torch.equal(plan.idx[a], idx[a]) and torch.equal(plan.weights[a], w[a])
        assert plan.weights[a].dtype == (weight_dtype or torch.float32)
        assert plan.idx[a].shape == (K.BASES[method].support, 6, 5, 7)


@pytest.mark.parametrize("m", [1, 3, 4, 5, 1023, 1024, 1027, 4 * 256 * 3 + 2])
def test_thread_mapping_writes_every_plane_element_once(m):
    """Every thread of every block: its points p0 .. p0 + 3 (fewer at the
    tail, where m % 4 != 0) in each of the 2 * 3 * S planes; together each
    element of the (3, S, m) outputs exactly once, and nothing past them."""
    support = 4
    threads = -(-m // POINTS)
    blocks = -(-threads // THREADS)
    hits = np.zeros(3 * support * m, np.int64)
    for tid in range(blocks * THREADS):
        p0 = tid * POINTS
        if p0 >= m:
            continue
        cnt = min(POINTS, m - p0)
        for plane in range(3 * support):
            hits[plane * m + p0:plane * m + p0 + cnt] += 1
    assert (hits == 1).all()


def _kernel_indices(q: np.ndarray, method: str, shape, wrap):
    """The kernel's index arithmetic in int32: floor, conversion toward zero
    of the integral value, + offset + tap, C's ``%`` made non-negative or a
    clamp, times the stride."""
    support, offset = K.BASES[method].support, K.BASES[method].offset
    n1, n2, n3 = shape
    strides = (n2 * n3, n3, 1)
    out = []
    for a, n in enumerate(shape):
        base = np.floor(q[a]).astype(np.int32) + np.int32(offset)
        taps = []
        for s in range(support):
            i = base + np.int32(s)
            if wrap[a]:
                r = np.fmod(i, np.int32(n))          # C's %: the sign of i
                i = np.where(r < 0, r + np.int32(n), r)
            else:
                i = np.minimum(np.maximum(i, 0), n - 1)
            taps.append((i * np.int32(strides[a])).astype(np.int32))
        out.append(np.stack(taps))
    return out


@pytest.mark.parametrize("wrap", [(True, True, True), (False, True, True)], ids=["TTT", "FTT"])
@pytest.mark.parametrize("method", I.METHODS)
def test_kernel_index_arithmetic_matches_the_plain_build(method, wrap):
    """Queries spread +-12 around the grid (far across the seam and the
    clamp), shifted by -9.5, exact integers and -0.0, on a halo-extended
    field."""
    shape = (20, 8, 12)
    q = torch.cat([_queries((8, 8, 12), 2, spread=12.0),
                   _queries((8, 8, 12), 3, offset=-9.5),
                   torch.floor(_queries((8, 8, 12), 4, spread=12.0))], dim=1)
    q[:, 0, 0] = -0.0
    idx, _ = KP.build_plan_plain(q, method, None, shape, wrap)
    for got, ref in zip(_kernel_indices(q.numpy(), method, shape, wrap), idx):
        np.testing.assert_array_equal(got, ref.numpy())

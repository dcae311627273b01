"""CPU emulation of the block mapping of kernels K2 (``apply_plan``), K3
(``apply_plan_fused``) and K4 (``interp3d``) in
``src/repro_torch/csrc/interp3d.cu``, of K4's shared-memory source box
(cubic bases) and of K3's field-interleaved gather.

The kernels cannot run here, so this file replays their index arithmetic in
PyTorch: the output tiles of ``kernels.interp3d.out_tiling`` (one block of
256 threads per tile), each K4 block's min / max source box, the over-budget
decision against ``BOX_FLOATS`` (or a smaller budget), the floor-mod load of
the box into a buffer, pass by pass when not all K fields fit at once, the
box-local indices and the gather in the unchanged tap order a -> b -> c.
Blocks over budget, and K2 and linear K4 everywhere, take the global gather
at wrapped indices. K3 is replayed thread by thread: the launch grid and
block of ``tiled_launch``, each thread's output voxel (``OutVoxel``), and
one pass over the taps a -> b -> c that forms each tap weight once and
gathers both fields with it, then the epilogue. The result must
equal the plain version bit for bit: the same values summed in the same order
with the same float operations. Fields of 8^3, 5^3 (the box is wider than
the grid) and 16 x 24 x 40, queries near the identity, across the periodic
seam (-9.5 and +(n - 0.5)), uniform over the grid, and a flattened output;
for K3 also a halo-extended field gathered at its interior (the slab
solve's plans).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import interp as I
from repro_torch.kernels import interp3d as K

SHAPES = [(8, 8, 8), (5, 5, 5), (16, 24, 40)]
#: (field shape, query set): every set on every field, the flattened output
#: on the largest
CASES = [(shape, kind) for shape in SHAPES
         for kind in ("near", "seam_lo", "seam_hi", "uniform")] + [((16, 24, 40), "flat")]
DTYPES = {"fp32": None, "bf16": torch.bfloat16}


def _queries(shape, kind, seed=0):
    """Query points (3, *out_shape) in index units, made with numpy."""
    rng = np.random.default_rng(seed)
    n = np.asarray(shape, np.float32).reshape(3, 1, 1, 1)
    x = np.stack(np.meshgrid(*[np.arange(k, dtype=np.float32) for k in shape],
                             indexing="ij"))
    if kind == "uniform":
        q = rng.uniform(0.0, 1.0, x.shape).astype(np.float32) * n
    elif kind == "wide-9.5":
        q = x + rng.uniform(-3.0, 3.0, x.shape).astype(np.float32) - 9.5
    else:
        q = x + rng.uniform(-1.5, 1.5, x.shape).astype(np.float32)
        q = {"seam_lo": q - 9.5, "seam_hi": q + (n - 0.5)}.get(kind, q)
    q = torch.from_numpy(np.ascontiguousarray(q, np.float32))
    return q.reshape(3, -1) if kind == "flat" else q


def _blocks(out_shape, tile3d):
    """The block of each output point (M,) in the kernels' tile mapping, and
    the number of blocks."""
    dims, tile = K.out_tiling(out_shape, tile3d)
    grid = [-(-d // t) for d, t in zip(dims, tile)]
    b1, b2, b3 = (torch.arange(d) // t for d, t in zip(dims, tile))
    block = (b1[:, None, None] * grid[1] + b2[None, :, None]) * grid[2] + b3[None, None, :]
    return block.reshape(-1), math.prod(grid)


def _fields_per_pass(extent, nfields, budget):
    """The kernel's decision: fields staged at once, 0 when over budget (or
    wider along x3 than two columns a lane)."""
    if budget <= 0 or any(e > budget for e in extent) or extent[2] > K.BOX_MAX_E3:
        return 0
    vol = math.prod(extent)
    return min(nfields, budget // vol) if vol <= budget else 0


def _emulate(f, coords, global_idx, weights, out_shape, tile3d, budget):
    """The kernel's gather over all blocks.

    f           (K, N1, N2, N3) fields;
    coords      three (S, M) int tensors: each tap's source coordinate on an
                axis, not wrapped; a block's box is [min, max] of them on
                each axis;
    global_idx  three (S, M) wrapped, stride-premultiplied indices, as the
                global branch reads them;
    weights     three tuples of S weight tensors (M,) in the weight dtype.
    Returns (out (K, M), share of blocks that staged their box)."""
    nf, n1, n2, n3 = f.shape
    f_flat = f.reshape(nf, -1)
    support, m = coords[0].shape
    block, nblocks = _blocks(out_shape, tile3d)
    c = [x.long() for x in coords]
    # the block-wide min and max on each axis (the kernel's block reduction)
    lo = [torch.full((nblocks,), 2 ** 62).scatter_reduce(0, block, x.amin(0), "amin")
          for x in c]
    hi = [torch.full((nblocks,), -2 ** 62).scatter_reduce(0, block, x.amax(0), "amax")
          for x in c]
    extent = torch.stack([h - l + 1 for l, h in zip(lo, hi)])  # (3, nblocks)
    # per block and field: where its box starts in the buffer (-1: global)
    start = torch.full((nf, nblocks), -1, dtype=torch.long)
    buffers, used = [], 0
    for j in range(nblocks):
        e = [int(x) for x in extent[:, j]]
        per_pass = _fields_per_pass(e, nf, budget)
        if per_pass == 0:
            continue
        g1, g2, g3 = (torch.remainder(int(lo[a][j]) + torch.arange(e[a]), n)
                      for a, n in enumerate((n1, n2, n3)))
        for k0 in range(0, nf, per_pass):
            count = min(per_pass, nf - k0)
            box = f[k0:k0 + count][:, g1][:, :, g2][:, :, :, g3].reshape(-1)
            buffers.append(box)
            start[k0:k0 + count, j] = used + torch.arange(count) * (box.numel() // count)
            used += box.numel()
    box_base = start[:, block]                        # (K, M)
    in_box = box_base >= 0
    # box-local tap indices, premultiplied by the box's strides
    ext = extent[:, block]
    strides = (ext[1] * ext[2], ext[2], torch.ones_like(ext[2]))
    local = [(c[a] - lo[a][block]) * strides[a] for a in range(3)]
    # every tap's value, from the block's box or from the field: one flat
    # source of the fields and then the boxes
    source = torch.cat([f_flat.reshape(-1)] + buffers)
    n = n1 * n2 * n3
    k_off = (torch.arange(nf) * n)[:, None]
    w1, w2, w3 = (torch.stack(w) for w in weights)    # (S, M) each
    acc = torch.zeros((nf, m), dtype=torch.float32)
    for a in range(support):
        for b in range(support):
            wab = w1[a] * w2[b]
            for c3 in range(support):
                gidx = global_idx[0][a] + global_idx[1][b] + global_idx[2][c3]
                lidx = local[0][a] + local[1][b] + local[2][c3]
                src = torch.where(in_box, nf * n + box_base + lidx, k_off + gidx.long())
                acc = acc + K._tap_product(wab, w3[c3], source[src]).to(torch.float32)
    return acc, float((start[0] >= 0).float().mean())


def emulate_interp3d(coef, q, basis, weight_dtype=None, budget=K.BOX_FLOATS):
    """K4 as the kernel computes it, block by block; returns (out, box share).
    Linear stages no box (budget 0)."""
    support, offset = K.BASES[basis].support, K.BASES[basis].offset
    n = tuple(coef.shape[-3:])
    lead, out_shape = tuple(coef.shape[:-3]), tuple(q.shape[1:])
    qf = q.reshape(3, -1)
    fl = torch.floor(qf)
    base = fl.to(torch.int32) + offset
    weights = [K.query_weights(basis, (qf - fl)[a], weight_dtype) for a in range(3)]
    taps = torch.arange(support, dtype=torch.int32)[:, None]
    strides = (n[1] * n[2], n[2], 1)
    coords = [base[a][None] + taps for a in range(3)]
    global_idx = [torch.remainder(coords[a], n[a]) * strides[a] for a in range(3)]
    out, share = _emulate(coef.reshape((-1,) + n), coords, global_idx, weights, out_shape,
                          K.interp3d_tile(basis),
                          budget if K.interp3d_tile(basis) == K.TILE_3D_BOX else 0)
    return out.reshape(lead + out_shape), share


def emulate_apply_plan(coef, plan):
    """K2 as the kernel computes it, block by block, every block on the
    global gather at the plan's indices; returns out."""
    n1, n2, n3 = plan.field_shape
    support = plan.support
    lead, out_shape = tuple(coef.shape[:-3]), tuple(plan.out_shape)
    idx = [i.reshape(support, -1) for i in plan.idx]
    weights = [tuple(w.reshape(support, -1)) for w in plan.weights]
    out, _ = _emulate(coef.reshape((-1, n1, n2, n3)), idx, idx, weights, out_shape,
                      K.TILE_3D, 0)
    return out.reshape(lead + out_shape)


def k3_thread_voxels(out_shape):
    """The flat output voxel of every thread of K3's launch that has one, in
    launch order: ``tiled_launch``'s grid and block over ``out_tiling``'s
    tile (one output a thread) and ``OutVoxel``'s coordinates."""
    (m1, m2, m3), (t1, t2, t3) = K.out_tiling(out_shape)
    bz = 256 // (t2 * t3)
    assert 256 % (t2 * t3) == 0 and t1 == bz  # one output a thread
    grid = (-(-m3 // t3), -(-m2 // t2), -(-m1 // t1))
    gz, gy, gx, tz, ty, tx = torch.meshgrid(
        torch.arange(grid[2]), torch.arange(grid[1]), torch.arange(grid[0]),
        torch.arange(bz), torch.arange(t2), torch.arange(t3), indexing="ij")
    x1, x2, x3 = gz * bz + tz, gy * t2 + ty, gx * t3 + tx
    valid = (x1 < m1) & (x2 < m2) & (x3 < m3)
    return ((x1 * m2 + x2) * m3 + x3)[valid]


def emulate_apply_plan_fused(coefs, plan, extra, epilogue, dt):
    """K3 as the kernel computes it: each thread's voxel, its plan, and one
    pass over the taps a -> b -> c with the tap weight (wab * w3[c]) formed
    once and both fields gathered at the tap's index, then the epilogue."""
    support = plan.support
    out_shape = tuple(plan.out_shape)
    p = k3_thread_voxels(out_shape)
    assert torch.equal(torch.sort(p).values, torch.arange(math.prod(out_shape)))
    i1, i2, i3 = (i.reshape(support, -1)[:, p].long() for i in plan.idx)
    w1, w2, w3 = (w.reshape(support, -1)[:, p] for w in plan.weights)
    f0, f1 = coefs.reshape(2, -1)
    a0 = torch.zeros(p.shape, dtype=torch.float32)
    a1 = torch.zeros(p.shape, dtype=torch.float32)
    for a in range(support):
        for b in range(support):
            iab = i1[a] + i2[b]
            wab = w1[a] * w2[b]
            for c in range(support):
                i = iab + i3[c]
                wabc = wab.float() * w3[c].float()
                a0 = a0 + wabc * f0[i]
                a1 = a1 + wabc * f1[i]
    out = torch.full((math.prod(out_shape),), float("nan"))
    out[p] = K.EPILOGUES[epilogue][1](a0, a1, extra.reshape(-1)[p], dt)
    return out.reshape(out_shape)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The emulation runs thousands of small tensor ops. Beside other test
    workers, intra-op threads on every core make each op wait on the others:
    one thread is the fastest for them. Restored after this file."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _coef(shape, nf, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((nf,) + shape).astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("basis", I.METHODS)
@pytest.mark.parametrize("shape,kind", CASES, ids=lambda x: str(x))
def test_k4_box_emulation_is_bit_equal_to_plain(shape, kind, basis, dtype):
    """K = 3 fields at the box budget, and at a budget that stages them one
    or two at a time (or puts a wide block over budget)."""
    q = _queries(shape, kind)
    wd = DTYPES[dtype]
    coef = _coef(shape, 3)
    ref = K.interp3d_plain(coef, q, basis, wd)
    for budget in (K.BOX_FLOATS, 4000):
        got, _ = emulate_interp3d(coef, q, basis, wd, budget)
        assert torch.equal(got, ref), (budget, float((got - ref).abs().max()))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("basis", I.METHODS)
@pytest.mark.parametrize("shape,kind", CASES, ids=lambda x: str(x))
def test_k2_tile_emulation_is_bit_equal_to_plain(shape, kind, basis, dtype):
    q = _queries(shape, kind)
    plan = I.build_plan(q, basis, DTYPES[dtype], shape=shape)
    coef = _coef(shape, 3)
    got = emulate_apply_plan(coef, plan)
    ref = K.apply_plan_plain(coef, plan)
    assert torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("basis", I.METHODS)
@pytest.mark.parametrize("shape,kind", CASES, ids=lambda x: str(x))
def test_k3_tile_emulation_is_bit_equal_to_plain(shape, kind, basis, dtype):
    """Both epilogues, fp32 and bf16 weights, S = 4 and 2."""
    q = _queries(shape, kind)
    plan = I.build_plan(q, basis, DTYPES[dtype], shape=shape)
    coefs = _coef(shape, 2)
    extra = _coef(tuple(q.shape[1:]), 1, seed=2)[0]
    for epilogue in sorted(K.EPILOGUES):
        got = emulate_apply_plan_fused(coefs, plan, extra, epilogue, 0.25)
        ref = K.apply_plan_fused_plain(coefs, plan, extra, epilogue, 0.25)
        assert torch.equal(got, ref), (epilogue, float((got - ref).abs().max()))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("basis", I.METHODS)
def test_k3_tile_emulation_on_a_halo_extended_field(basis, dtype):
    """The slab solve's plan: the field has 2 x 3 halo rows on x1 (clamped,
    not wrapped), the output is the 10 x 24 x 40 interior, so the output
    shape differs from the field shape (and is not a multiple of the tile
    along x1 or x2)."""
    halo, interior = 3, (10, 24, 40)
    field = (interior[0] + 2 * halo,) + interior[1:]
    q = _queries(interior, "near")
    q[0] += halo
    plan = I.build_plan(q, basis, DTYPES[dtype], shape=field, wrap=(False, True, True))
    assert tuple(plan.out_shape) == interior and tuple(plan.field_shape) == field
    coefs = _coef(field, 2)
    extra = _coef(interior, 1, seed=2)[0]
    for epilogue in sorted(K.EPILOGUES):
        got = emulate_apply_plan_fused(coefs, plan, extra, epilogue, 0.25)
        ref = K.apply_plan_fused_plain(coefs, plan, extra, epilogue, 0.25)
        assert torch.equal(got, ref), (epilogue, float((got - ref).abs().max()))


def test_box_share_follows_the_queries():
    """Near-identity queries put every cubic K4 block in its box, also across
    the seam; uniform queries over a 16 x 24 x 40 grid put none there. With
    +-3 noise on a 24 x 16 x 32 grid the full 16 x 4 x 32 tiles' boxes are
    over budget and the shorter last x1 tile's are not; linear stages none."""
    shape = (16, 24, 40)
    coef = _coef(shape, 1)
    shares = {kind: emulate_interp3d(coef, _queries(shape, kind), "cubic_bspline")[1]
              for kind in ("near", "seam_lo", "seam_hi", "uniform")}
    assert shares["near"] == shares["seam_lo"] == shares["seam_hi"] == 1.0
    assert shares["uniform"] == 0.0
    assert emulate_interp3d(coef, _queries(shape, "near"), "linear")[1] == 0.0
    wide = (24, 16, 32)
    coef, q = _coef(wide, 1), _queries(wide, "wide-9.5")
    got, share = emulate_interp3d(coef, q, "cubic_lagrange")
    assert 0.0 < share < 1.0
    assert torch.equal(got, K.interp3d_plain(coef, q, "cubic_lagrange"))


@pytest.mark.parametrize("out_shape,dims,tile,blocks", [
    ((256, 256, 256), (256, 256, 256), K.TILE_3D, 128 * 64 * 8),
    ((16, 24, 40), (16, 24, 40), K.TILE_3D, 8 * 6 * 2),
    ((5, 5, 5), (5, 5, 5), K.TILE_3D, 3 * 2 * 1),
    ((256, 256, 256), (256, 256, 256), K.TILE_3D_BOX, 16 * 64 * 8),
    ((16, 24, 40), (16, 24, 40), K.TILE_3D_BOX, 1 * 6 * 2),
    ((1000,), (1, 1, 1000), K.TILE_FLAT, 4),
    ((2, 3, 4, 5), (1, 1, 120), K.TILE_FLAT, 1),
    ((200000, 1, 4), (1, 1, 800000), K.TILE_FLAT, 3125),
])
def test_out_tiling(out_shape, dims, tile, blocks):
    """3D outputs in 2 x 4 x 32 tiles (K4 with its box: 16 x 4 x 32), 256
    threads a block, other ranks flattened, and 3D outputs past the grid's
    y / z limit flattened too."""
    tile3d = K.TILE_3D_BOX if tile == K.TILE_3D_BOX else K.TILE_3D
    assert K.out_tiling(out_shape, tile3d) == (dims, tile)
    assert K.tile_blocks(out_shape, tile3d) == blocks
    assert math.prod(K.TILE_3D) == math.prod(K.TILE_FLAT) == 256
    assert K.TILE_3D_BOX[1:] == K.TILE_3D[1:] and K.TILE_3D_BOX[0] % K.TILE_3D[0] == 0

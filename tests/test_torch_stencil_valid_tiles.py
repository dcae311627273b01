"""CPU emulation of kernel K5 (``stencil_valid_f32`` in
``src/repro_torch/csrc/pencil.cu``), the valid-mode FD8 stencil of the slab
solve, against its plain version ``kernels.pencil.stencil_valid_plain``.

The kernel cannot run here, so this file replays its index arithmetic in
PyTorch, with the constants read from the source:

* axes 0 and 1 (strided): the grid of ``outer * chunks`` x column blocks,
  each thread's column and chunk, its register window of kChunk + 2R rows
  read from the extended input with no wrap (rows past the input's end left
  unread), and the outputs of the chunk that exist;
* axis 2 (rows): each CTA's rows staged as they are, n3 + 2R input values
  at shared-memory offset kPad - R, then each thread's four float4 outputs
  from a 20-value window (n3 % 4 == 0 and R % 4 == 0) or one output from a
  window masked to the radius (the scalar path).

Unstaged shared memory is NaN here, so a window that reached past what the
CTA staged would show. The sums run in the kernel's tap order (0, then k =
1..R, then the scale), and the result must equal the plain version bit for
bit, at n_loc = 2 (thinner than the radius), 16, 72 and 130 rows, for one
field and a K = 3 stack.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import fd8 as FD8
from repro_torch.kernels import pencil as P

SOURCE = pathlib.Path(P.__file__).resolve().parents[1] / "csrc" / "pencil.cu"
TAPS = FD8.FD8_COEFFS
R = len(TAPS)
SCALE = 0.7


def _cu_const(name: str) -> int:
    hit = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert hit, name
    return int(hit.group(1))


CHUNK, COL_THREADS = _cu_const("kChunk"), _cu_const("kColThreads")
PAD, ROW_THREADS = _cu_const("kPad"), _cu_const("kRowThreads")


def _taps(window_p, window_m):
    """acc = 0, then acc + c_k (f[+k] - f[-k]) for k = 1..R, then * scale;
    ``window_p(k)`` / ``window_m(k)`` give the values k rows after / before."""
    acc = torch.zeros_like(window_p(1))
    for k, c in enumerate(TAPS, start=1):
        acc = acc + c * (window_p(k) - window_m(k))
    return acc * SCALE


def emulate_strided(f, axis):
    """Axes 0 and 1: ``stencil_valid_strided_kernel`` over its whole grid."""
    lead = f.shape[:-3]
    n1, n2, n3 = f.shape[-3:]
    batch = math.prod(lead)
    outer = batch if axis == 0 else batch * n1
    n_in = (n1, n2)[axis]
    n = n_in - 2 * R
    inner = n2 * n3 if axis == 0 else n3
    x = f.reshape(outer, n_in, inner)
    chunks = -(-n // CHUNK)
    threads = COL_THREADS if inner >= COL_THREADS else -(-inner // 32) * 32
    col_blocks = -(-inner // threads)
    out = torch.full((outer, n, inner), float("nan"))
    for bx in range(outer * chunks):          # blockIdx.x: chunk fastest
        chunk, o = bx % chunks, bx // chunks
        i0 = chunk * CHUNK
        avail = n_in - i0
        cols = torch.arange(col_blocks * threads)
        cols = cols[cols < inner]              # threads past inner return
        # w[r] = f_ext[i0 + r] for r < avail, else 0 (not read)
        w = torch.zeros((CHUNK + 2 * R, cols.numel()))
        rows = min(avail, CHUNK + 2 * R)
        w[:rows] = x[o, i0:i0 + rows][:, cols]
        n_out = min(n - i0, CHUNK)
        t = torch.arange(n_out)
        val = _taps(lambda k: w[t + R + k], lambda k: w[t + R - k])
        out[o, i0:i0 + n_out][:, cols] = val
    shape = list(f.shape)
    shape[len(lead) + axis] = n
    return out.reshape(shape)


def emulate_rows(f):
    """Axis 2: ``stencil_valid_rows_kernel``, CTA by CTA."""
    lead = f.shape[:-3]
    n1, n2, n_in = f.shape[-3:]
    n = n_in - 2 * R
    rows = math.prod(lead) * n1 * n2
    x = f.reshape(rows, n_in)
    vec = n % 4 == 0 and R % 4 == 0
    q = n // 4 if vec else n
    bx = min(q, ROW_THREADS)
    by = ROW_THREADS // bx
    ld = n + 2 * PAD
    out = torch.full((rows, n), float("nan"))
    for block in range(-(-rows // by)):
        live = torch.arange(block * by, min((block + 1) * by, rows))
        sm = torch.full((live.numel(), ld), float("nan"))
        # srow = sm + kPad; input value i goes to srow[i - R]
        sm[:, PAD - R:PAD - R + n_in] = x[live]
        if vec:
            # thread column c: w[u] = srow[4c - 8 + u], outputs 4c .. 4c + 3
            win = sm.unfold(1, 20, 4)[:, :n // 4]         # (rows, n / 4, 20)
            assert PAD == 8
            val = torch.stack([_taps(lambda k, j=j: win[..., 8 + j + k],
                                     lambda k, j=j: win[..., 8 + j - k])
                               for j in range(4)], dim=-1)
            out[live] = val.reshape(live.numel(), n)
        else:
            # w[d + kPad] = srow[c + d] for |d| <= R, else 0
            win = sm.unfold(1, 2 * PAD + 1, 1)[:, :n]      # srow[c - 8 .. c + 8]
            d = torch.arange(-PAD, PAD + 1)
            win = torch.where((d.abs() <= R), win, torch.zeros(()))
            out[live] = _taps(lambda k: win[..., PAD + k], lambda k: win[..., PAD - k])
    return out.reshape(lead + (n1, n2, n))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small tensor ops: one intra-op thread is the fastest beside
    other test workers (as tests/test_torch_interp3d_tiles.py). Restored
    after this file."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _field(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


@pytest.mark.parametrize("lead", [(), (3,)], ids=["K1", "K3"])
@pytest.mark.parametrize("n_loc", [2, 16, 72, 130])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_k5_emulation_is_bit_equal_to_plain(axis, n_loc, lead):
    """n_loc = 2 is thinner than the radius; 72 and 130 end in a part chunk
    (axes 0, 1) and take the scalar rows path at 130 and 2 (axis 2)."""
    shape = [6, 8, 12]
    shape[axis] = n_loc + 2 * R
    f = _field(lead + tuple(shape), 7 * axis + n_loc)
    got = emulate_strided(f, axis) if axis < 2 else emulate_rows(f)
    ref = P.stencil_valid_plain(f, axis, TAPS, SCALE)
    assert got.shape == ref.shape and got.shape[len(lead) + axis] == n_loc
    assert torch.equal(got, ref), float((got - ref).abs().max())


def test_k5_emulation_at_a_wide_column_block():
    """Axis 0 with inner = 9 x 40 = 360 columns: three 128-thread column
    blocks, the last one part-filled, over a 4-slab-like stack."""
    f = _field((5, 20 + 2 * R, 9, 40), 3)
    assert torch.equal(emulate_strided(f, 0), P.stencil_valid_plain(f, 0, TAPS, SCALE))


def test_kernel_constants_match_the_design():
    """The window is wide enough for any radius the wrapper takes, and the
    rows path's 20-value window covers four outputs' taps at R = 4."""
    assert PAD >= P.MAX_TAPS and PAD % 4 == 0
    assert CHUNK % 32 == 0 and COL_THREADS % 32 == 0 and ROW_THREADS % 32 == 0
    assert 20 >= 4 + 2 * R

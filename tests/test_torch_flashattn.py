"""Port parity of the flash-attention kernel's plain version (K6 on the card)
and of the prefill attention around it.

Same numpy inputs through the JAX package and the port:
  * ``repro_torch.kernels.flashattn.flash_attention`` on the CPU (the plain
    version) against JAX ``ops.flash_attention`` (the Pallas kernel in
    interpret mode) on ``tests/test_flashattn.py``'s grid, at its tolerances:
    fp32 rtol = atol = 2e-4, bf16 rtol = atol = 2e-2;
  * ``repro_torch.models.attention.multihead_attention`` (GQA through the
    K/V repeat) against JAX's blockwise ``multihead_attention`` in fp32 at
    rtol = atol = 2e-4, with S ragged against JAX's 512-row query block;
  * a plain-PyTorch emulation of the card kernel's bf16 tile arithmetic
    (``_k6_bf16_tiles``) against the plain version, at K6's bf16 check.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flashattn import ops, ref
from repro.kernels.flashattn.flashattn import hbm_traffic_model
from repro.models import attention as JA
from repro_torch.kernels import counts
from repro_torch.kernels import flashattn as FA
from repro_torch.models import attention as TA

TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _both(shape, seed, dtype):
    """One numpy draw as a JAX array and a torch tensor of ``dtype`` (both
    round fp32 to bf16 to nearest-even, so the inputs are equal)."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("s,qb,kc", [(64, 32, 32), (128, 32, 16),
                                     (96, 32, 32), (64, 64, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_flash_kernel(s, qb, kc, causal, dtype):
    bh, hd = 4, 16
    (qj, qt), (kj, kt), (vj, vt) = (_both((bh, s, hd), i, dtype) for i in range(3))
    want = ops.flash_attention(qj, kj, vj, causal=causal, q_block=qb, kv_chunk=kc)
    counts.reset()
    got = FA.flash_attention(qt, kt, vt, causal=causal)
    assert counts.snapshot() == {"plain:flash_attention": 1}
    assert got.dtype == qt.dtype and got.shape == (bh, s, hd)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
def test_oracle_matches_jax_oracle_and_plain(causal):
    (qj, qt), (kj, kt), (vj, vt) = (_both((3, 80, 16), 10 + i, "float32") for i in range(3))
    oracle = FA.attention(qt, kt, vt, causal)
    np.testing.assert_allclose(_np(oracle), _np(ref.attention(qj, kj, vj, causal)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(FA.flash_attention_plain(qt, kt, vt, causal)),
                               _np(oracle), rtol=2e-4, atol=2e-4)


def test_uniform_v_gives_v_rows():
    """Uniform V: attention output equals the V row regardless of scores."""
    bh, s, hd = 2, 64, 16
    _, q = _both((bh, s, hd), 3, "float32")
    _, k = _both((bh, s, hd), 4, "float32")
    v = torch.arange(hd, dtype=torch.float32).expand(bh, s, hd).contiguous()
    for causal in (False, True):
        torch.testing.assert_close(FA.flash_attention(q, k, v, causal), v,
                                   rtol=1e-5, atol=1e-5)


def test_traffic_model_matches_jax():
    for args in ((32768, 64, 20, 2), (512, 64, 20, 2), (2048, 128, 28, 8, 256, 4)):
        assert FA.hbm_traffic_model(*args) == hbm_traffic_model(*args)


def test_wrapper_refuses_what_the_kernel_contract_excludes():
    q = torch.zeros((2, 8, 16))
    with pytest.raises(TypeError, match="one dtype"):
        FA.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match=r"k, v \(BH, S_kv, hd\)"):
        FA.flash_attention(q, q[..., :8], q[..., :8])
    with pytest.raises(ValueError, match="outside the 4 keys"):
        FA.flash_attention(q, q[:, :4], q[:, :4])
    with pytest.raises(ValueError, match="outside the 8 keys"):
        FA.flash_attention(q[:, :4], q, q, q_offset=5)
    with pytest.raises(ValueError, match="cpu or cuda"):
        m = q.to("meta")
        FA.flash_attention(m, m, m)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_kv,s_q,offset", [(64, 16, 0), (64, 16, 48), (70, 35, 35),
                                             (70, 20, 13)])
def test_plain_with_a_query_offset_matches_attention_on_those_rows(s_kv, s_q, offset, dtype,
                                                                   causal):
    """K6's plain version on rows ``offset .. offset + s_q`` of the queries
    against every key (the sequence-parallel prefill's layout) against the
    oracle on the whole sequence restricted to those rows, at K6's
    tolerances; offset 0 with as many queries as keys is the plain version
    of old, bit for bit."""
    q, k, v = (_both((3, s_kv, 16), seed, dtype)[1] for seed in (1, 2, 3))
    got = FA.flash_attention_plain(q[:, offset:offset + s_q], k, v, causal, q_offset=offset)
    want = FA.attention(q, k, v, causal)[:, offset:offset + s_q]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **TOL[dtype])
    assert torch.equal(FA.flash_attention(q, k, v, causal=causal, q_offset=0),
                       FA.flash_attention_plain(q, k, v, causal))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n_kv,group", [(2, 2), (4, 1), (1, 3)])
def test_multihead_attention_matches_jax(n_kv, group, causal):
    """S = 600 is ragged against JAX's 512-row query block (JAX then takes
    one 600-row block with 300-key chunks); the port folds the heads, repeats
    K/V for G > 1 and calls the kernel's plain version."""
    b, s, hd = 1, 600, 16
    qj, qt = _both((b, s, n_kv, group, hd), 20, "float32")
    kj, kt = _both((b, s, n_kv, hd), 21, "float32")
    vj, vt = _both((b, s, n_kv, hd), 22, "float32")
    want = JA.multihead_attention(qj, kj, vj, causal)
    counts.reset()
    got = TA.multihead_attention(qt, kt, vt, causal)
    assert counts.snapshot() == {"plain:flash_attention": 1}
    assert got.shape == (b, s, n_kv, group, hd)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


#: K6's bf16 check on the card (``chip_smoke.py``): within rtol 8e-3 / atol
#: 1e-4 of the plain version, with at most 5% of the elements differing.
K6_BF16 = dict(rtol=8e-3, atol=1e-4, differ=0.05)


def _k6_bf16_tiles(q, k, v, causal, split_p=True):
    """The card kernel's bf16 arithmetic in plain PyTorch: fp32 scores of the
    bf16 inputs, scaled afterwards, inside the exponent (in log2 units: the
    kernel's exp is exp2);
    an online softmax over 64-key tiles with m, l and acc in fp32; P.V with p
    as two bf16 halves hi = bf16(p), lo = bf16(p - hi), each product summed
    in fp32 (``split_p=False``: p rounded to bf16, the fault the split
    avoids); out = acc / max(l, 1e-30) rounded once to bf16."""
    bh, s_len, hd = q.shape
    scale_log2 = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32) * math.log2(math.e)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, s_len, 1), -1e30)
    l = torch.zeros((bh, s_len, 1))
    acc = torch.zeros((bh, s_len, hd))
    rows = torch.arange(s_len)
    for k0 in range(0, s_len, 64):
        keys = torch.arange(k0, min(k0 + 64, s_len))
        x = qf @ kf[:, keys].transpose(-1, -2)
        if causal:
            x = x.masked_fill(keys[None, :] > rows[:, None], -1e30)
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True) * scale_log2)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x * scale_log2 - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr
        hi = p.bfloat16().float()
        acc = acc + hi @ vf[:, keys]
        if split_p:
            acc = acc + (p - hi).bfloat16().float() @ vf[:, keys]
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).bfloat16()


def _k6_bf16_check(got, ref):
    d = (got.float() - ref.float()).abs()
    within = bool((d <= K6_BF16["atol"] + K6_BF16["rtol"] * ref.float().abs()).all())
    return within and float((d > 0).float().mean()) <= K6_BF16["differ"]


@pytest.mark.parametrize("split_p", [True, False], ids=["p_split", "p_bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [64, 128])
def test_k6_bf16_tile_arithmetic_meets_the_card_check(hd, causal, split_p):
    """S = 300 ends in a part tile. The split P.V passes K6's bf16 check
    against the plain version; p rounded to bf16 before P.V must fail it."""
    q, k, v = (_both((4, 300, hd), 30 + i, "bfloat16")[1] for i in range(3))
    got = _k6_bf16_tiles(q, k, v, causal, split_p)
    assert _k6_bf16_check(got, FA.flash_attention_plain(q, k, v, causal)) == split_p

"""Decode at or past the end of the KV cache, as JAX does it.

JAX's ``decode_self_attention`` writes the new K/V with
``dynamic_update_slice_in_dim``, which clamps the slot to S - 1, and masks
with the unclamped position (every slot valid once position >= S - 1);
RoPE takes the unclamped position. The encoder-decoder family reaches this
on every served decode step (``make_cache(B, P + G)`` gives ``dec_len(P +
G)`` self-attention slots and decode starts at P). fp32 smoke config of
qwen1.5-0.5b (GQA 4/2, QKV bias, RoPE); outputs and caches at rtol = atol =
1e-5 (fp32 order; the cache is bf16 and equal to one bf16 ulp, 2^-7
relative), and the dense serve path's greedy ids equal to JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.launch import serve_lm
from repro_torch.models import attention as TA

from _torch_lm_parity import LAYER_TOL, jax_serve, layer, pair, rand, tokens, to_np, ttree

S = 4


@pytest.mark.parametrize("positions", [(4,), (7,), (2, 3, 4, 7)], ids=str)
def test_decode_self_attention_past_the_cache_matches_jax(positions):
    jm, params, tm = pair("qwen1.5-0.5b", fp32=True)
    cfg = tm.cfg
    pn, pj = layer(params, ("decoder", "seg0", "sub0", "mixer"))
    pt = ttree(pn)
    k0 = rand((2, S, cfg.n_kv_heads, cfg.head_dim), 1)
    v0 = rand((2, S, cfg.n_kv_heads, cfg.head_dim), 2)
    cj = {"k": jnp.asarray(k0, jnp.bfloat16), "v": jnp.asarray(v0, jnp.bfloat16)}
    ct = {"k": torch.from_numpy(k0).bfloat16(), "v": torch.from_numpy(v0).bfloat16()}
    for i, pos in enumerate(positions):
        x = rand((2, 1, cfg.d_model), 10 + i)
        oj, cj = JA.decode_self_attention(pj, jm.cfg, jnp.asarray(x), cj,
                                          jnp.asarray(pos, jnp.int32), jnp.float32)
        ot, ct = TA.decode_self_attention(pt, cfg, torch.from_numpy(x), ct, pos,
                                          torch.float32)
        np.testing.assert_allclose(to_np(ot), to_np(oj), **LAYER_TOL)
        for n in ("k", "v"):
            assert ct[n].shape == (2, S, cfg.n_kv_heads, cfg.head_dim)
            np.testing.assert_allclose(to_np(ct[n]), to_np(cj[n]), rtol=2.0 ** -7, atol=1e-6)
    # past the end only the last slot was written
    if min(positions) >= S:
        np.testing.assert_array_equal(to_np(ct["k"])[:, :S - 1],
                                      to_np(torch.from_numpy(k0).bfloat16())[:, :S - 1])


def test_dense_serve_ids_unchanged():
    """Dense serving never reaches the clamp (decode stops at P + G - 1 <
    P + G slots): its greedy ids stay JAX's."""
    jm, params, tm = pair("qwen1.5-0.5b", fp32=True)
    tok = tokens((3, 12), 16)
    want = jax_serve(jm, params, {"tokens": jnp.asarray(tok, jnp.int32)}, 6)
    got = serve_lm.serve(tm, {"tokens": torch.from_numpy(tok)}, 6)
    np.testing.assert_array_equal(got.ids.numpy(), want)

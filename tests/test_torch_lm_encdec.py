"""Port parity of the encoder-decoder family: sinusoidal positions,
``cross_attention`` and ``decode_cross_attention``, and whisper-large-v3's
smoke config (2 + 2 layers, MHA, LayerNorm, GELU, no RoPE): inputs, the
encoder, prefill, decode (self and cross caches) and serve, whose decode
steps all land past the end of the self-attention cache.

The JAX side runs on the same weights (``PRNGKey(0)`` carried across) and
numpy inputs (frames given in bf16, as ``make_batch`` gives them). fp32:
layers rtol = atol = 1e-5, logits within 1e-4 * max|logits|, the bf16 K/V
caches within one bf16 ulp (rtol 2^-7), greedy ids equal; bf16: logits atol
0.02 (prefill also equal argmax), caches rtol = atol = 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as JAPI
from repro.models import attention as JA
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import counts
from repro_torch.launch import serve_lm
from repro_torch.models import api as TAPI
from repro_torch.models import attention as TA

from _torch_lm_parity import (LAYER_TOL, assert_logits, assert_trees_close, batch_pair,
                              decode_steps, jax_serve, jitted, layer, pair, rand, to_np,
                              tokens, ttree)

ARCH = "whisper-large-v3"
CROSS = ("decoder", "seg0", "sub0", "cross")


@pytest.mark.parametrize("d", [64, 63, 1280])
def test_sinusoidal_matches_jax(d):
    """sin then cos, cut to d, at whisper's 1500 frames and decode positions
    past them; atol 2e-4: an angle of up to 1531 rad carries one fp32 ulp of
    1.2e-4 (the two frameworks' pow rounds it otherwise)."""
    tol = dict(rtol=0, atol=2e-4)
    np.testing.assert_allclose(TAPI._sinusoidal(1500, d, torch.float32, "cpu").numpy(),
                               np.asarray(JAPI._sinusoidal(1500, d, jnp.float32)), **tol)
    for pos in (0, 17, 1531):
        np.testing.assert_allclose(
            TAPI._sinusoidal_at(pos, d, torch.float32, "cpu").numpy(),
            np.asarray(JAPI._sinusoidal_at(jnp.asarray(pos, jnp.int32), d, jnp.float32)),
            **tol)
    np.testing.assert_array_equal(TAPI._sinusoidal(40, d, torch.float32, "cpu")[17].numpy(),
                                  TAPI._sinusoidal_at(17, d, torch.float32, "cpu").numpy())


def test_cross_attention_matches_jax():
    jm, params, tm = pair(ARCH, fp32=True)
    pn, pj = layer(params, CROSS)
    x, enc = rand((2, 8, tm.cfg.d_model), 1), rand((2, 24, tm.cfg.d_model), 2)
    want = JA.cross_attention(pj, jm.cfg, jnp.asarray(x), jnp.asarray(enc), jnp.float32)
    counts.reset()
    got = TA.cross_attention(ttree(pn), tm.cfg, torch.from_numpy(x), torch.from_numpy(enc),
                             torch.float32)
    assert counts.snapshot() == {}    # plain PyTorch, not K6
    np.testing.assert_allclose(to_np(got), to_np(want), **LAYER_TOL)


def test_decode_cross_attention_matches_jax():
    jm, params, tm = pair(ARCH, fp32=True)
    pn, pj = layer(params, CROSS)
    cfg = tm.cfg
    x = rand((2, 1, cfg.d_model), 3)
    k, v = (rand((2, 24, cfg.n_kv_heads, cfg.head_dim), s) for s in (4, 5))
    want = JA.decode_cross_attention(pj, jm.cfg, jnp.asarray(x), jnp.asarray(k),
                                     jnp.asarray(v), jnp.float32)
    got = TA.decode_cross_attention(ttree(pn), cfg, torch.from_numpy(x), torch.from_numpy(k),
                                    torch.from_numpy(v), torch.float32)
    np.testing.assert_allclose(to_np(got), to_np(want), **LAYER_TOL)


def _batch(tm, b, frames, seed):
    return batch_pair({"frames": rand((b, frames, tm.cfg.d_model), seed),
                       "tokens": tokens((b, tm.dec_len(frames)), seed + 1)})


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_prefill_logits_match_jax(fp32):
    """32 frames -> 16 decoder tokens; K6 (its plain version here) once per
    encoder layer (non-causal) and per decoder layer (causal)."""
    jm, params, tm = pair(ARCH, fp32)
    jb, tb = _batch(tm, 2, 32, 12)
    want = jitted(jm)[0](params, jb)
    counts.reset()
    got = tm.prefill(tb)
    assert counts.snapshot() == {"plain:flash_attention": tm.cfg.n_enc_layers
                                 + tm.cfg.n_layers}
    assert_logits(got, want, fp32)


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_decode_steps_match_jax(fp32):
    """Four steps on ``make_cache(2, 160)``: 20 self-attention slots, 160
    zero cross slots, positions 18-21 (the last two past the end)."""
    jm, params, tm = pair(ARCH, fp32)
    tol = dict(rtol=2.0 ** -7, atol=1e-6) if fp32 else dict(rtol=2e-2, atol=2e-2)
    for _, lj, lt, cj, ct in decode_steps(jm, params, tm, tokens((2, 4), 14), 160, start=18):
        assert ct["seg0"]["sub0"][0]["self"]["k"].shape[1] == 20
        assert ct["seg0"]["sub0"][0]["cross"]["k"].shape[1] == 160
        assert_logits(lt, lj, fp32, argmax=False)
        assert_trees_close(ct, cj, **tol)


def test_serve_greedy_ids_match_jax_fp32():
    """16 frames and 16 tokens, 5 generated: ``make_cache(3, 21)`` gives
    dec_len(21) = 16 self slots, and decode runs at positions 16-20, every
    step past the end of the cache (JAX clamps the write to slot 15)."""
    jm, params, tm = pair(ARCH, fp32=True)
    jb, tb = _batch(tm, 3, 16, 16)
    assert serve_lm.prompt_len(tb) == 16 and tm.dec_len(21) == 16
    np.testing.assert_array_equal(serve_lm.serve(tm, tb, 5).ids.numpy(),
                                  jax_serve(jm, params, jb, 5))


def test_whisper_encdec_shapes():
    """``test_models.py::test_whisper_encdec_shapes`` on the port's inputs,
    and the decode cache's two parts."""
    _, _, tm = pair(ARCH, fp32=False)
    batch = tm.make_batch(torch.Generator().manual_seed(1),
                          ShapeConfig("t", 64, 2, "prefill"))["batch"]
    assert batch["frames"].shape == (2, 64, tm.cfg.d_model)
    assert batch["frames"].dtype == torch.bfloat16
    assert batch["tokens"].shape == (2, tm.dec_len(64))
    assert torch.isfinite(tm.prefill(batch).float()).all()
    spec = tm.input_specs(ShapeConfig("d", 256, 2, "decode"))["cache"]["seg0"]["sub0"][1]
    assert spec["self"]["k"].shape == (2, 32, tm.cfg.n_kv_heads, tm.cfg.head_dim)
    assert spec["cross"]["v"].shape == (2, 256, tm.cfg.n_kv_heads, tm.cfg.head_dim)


def test_params_layout():
    """The encoder is one stacked segment of n_enc_layers (attn, dense)
    layers plus enc_norm; decoder layers carry norm_cross and cross."""
    _, params, tm = pair(ARCH, fp32=False)
    sd = tm.state_dict()
    assert sd["enc_norm.bias"].shape == (tm.cfg.d_model,)
    for r in range(tm.cfg.n_enc_layers):
        np.testing.assert_array_equal(
            to_np(sd[f"encoder.seg0.sub0.{r}.mixer.wq.w"]),
            to_np(params["encoder"]["seg0"]["sub0"]["mixer"]["wq"]["w"][r]))
        assert f"encoder.seg0.sub0.{r}.cross.wq.w" not in sd
    assert "decoder.seg0.sub0.1.norm_cross.scale" in sd
    assert "decoder.seg0.sub0.1.cross.wo.w" in sd

"""Port parity of the SSM family: ``models/ssm.py`` (the chunked SSD
prefill scan, the causal conv, the recurrent decode step and its fp32
cache) and mamba2-780m's smoke config (d_inner 128, 8 heads of 16, state
16, chunk 32): prefill, decode and serve.

The JAX side runs on the same weights (``PRNGKey(0)`` carried across) and
numpy inputs. fp32: layers rtol = atol = 1e-5, logits within 1e-4 *
max|logits|, greedy ids equal, the fp32 conv/state caches rtol = atol =
1e-5; bf16: logits atol 0.02 (prefill also equal argmax), each cache leaf
within 5e-2 * its max|.|. (The bf16 model's caches are fp32, built from bf16
projections: layer 1's conv buffer differs from JAX's by one bf16 ulp
(0.0156 at |x| ~3.5) where layer 0's output rounded otherwise, and its state
then by up to 2.1e-2 * max|state| after four steps; the fp32 tests hold the
arithmetic at 1e-5.) The SSD properties of ``test_attention_moe_ssm.py`` and
``test_models.py::test_decode_matches_prefill`` are checked on the port, the
first three beside the JAX functions on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import ssm as JS
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.kernels import counts
from repro_torch.launch import serve_lm
from repro_torch.models import ssm as TS

from _torch_lm_parity import (LAYER_TOL, assert_logits, assert_trees_close, batch_pair,
                              decode_steps, jax_serve, jitted, layer, pair, rand, to_np,
                              tokens, ttree)

ARCH = "mamba2-780m"
MIXER = ("decoder", "seg0", "sub0", "mixer")


def _mixer(fp32=True):
    jm, params, tm = pair(ARCH, fp32)
    pn, pj = layer(params, MIXER)
    return jm.cfg, tm.cfg, pj, ttree(pn)


@pytest.mark.parametrize("s", [64, 40, 16], ids=["2-chunks", "fallback-40", "one-chunk"])
def test_ssm_block_matches_jax(s):
    """Two chunks of 32; 40 tokens (not a multiple of 32: one chunk of 40);
    16 tokens (one short chunk)."""
    jcfg, tcfg, pj, pt = _mixer()
    x = rand((2, s, tcfg.d_model), 1, 0.5)
    want = JS.ssm_block(pj, jcfg, jnp.asarray(x), jnp.float32)
    got = TS.ssm_block(pt, tcfg, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(to_np(got), to_np(want), **LAYER_TOL)


def test_ssm_decode_step_matches_jax():
    """Four steps from a random fp32 cache: outputs, conv buffer and state."""
    jcfg, tcfg, pj, pt = _mixer()
    c0 = {k: rand(v.shape, 2 + i, 0.5) for i, (k, v) in
          enumerate(TS.make_ssm_cache(tcfg, 2, "cpu").items())}
    cj, ct = jax.tree.map(jnp.asarray, c0), ttree(c0)
    for i in range(4):
        x = rand((2, 1, tcfg.d_model), 10 + i)
        oj, cj = JS.ssm_decode_step(pj, jcfg, jnp.asarray(x), cj, jnp.float32)
        ot, ct = TS.ssm_decode_step(pt, tcfg, torch.from_numpy(x), ct, torch.float32)
        np.testing.assert_allclose(to_np(ot), to_np(oj), **LAYER_TOL)
        assert_trees_close(ct, cj, **LAYER_TOL)


def test_segsum_and_causal_conv_match_jax():
    a = rand((2, 3, 9), 3)
    want, got = np.asarray(JS._segsum(jnp.asarray(a))), TS._segsum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[..., 0, 1]).all() and np.isfinite(np.diagonal(got, 0, -2, -1)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **LAYER_TOL)
    for dt, jdt, tol in ((torch.float32, jnp.float32, LAYER_TOL),
                         (torch.bfloat16, jnp.bfloat16, dict(rtol=2 ** -7, atol=2 ** -7))):
        x, w, b = rand((2, 11, 12), 4), rand((4, 12), 5), rand((12,), 6)
        want = JS._causal_conv(*(jnp.asarray(t, jdt) for t in (x, w, b)), jdt)
        got = TS._causal_conv(*(torch.from_numpy(t).to(dt) for t in (x, w, b)), dt)
        assert got.dtype == dt
        np.testing.assert_allclose(to_np(got), to_np(want), **tol)


def test_softplus_is_logaddexp():
    x = np.array([-100.0, -20.0, -1.0, 0.0, 1.0, 19.0, 20.0, 21.0, 100.0], np.float32)
    np.testing.assert_allclose(TS._softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-38)  # XLA flushes softplus(-100)'s denormal


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_prefill_logits_match_jax(fp32):
    jm, params, tm = pair(ARCH, fp32)
    tok = tokens((2, 48), 12)
    want = jitted(jm)[0](params, {"tokens": jnp.asarray(tok, jnp.int32)})
    counts.reset()
    got = tm.prefill({"tokens": torch.from_numpy(tok)})
    assert counts.snapshot() == {}      # no attention layer, no K6
    assert_logits(got, want, fp32)


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_decode_steps_match_jax(fp32):
    """Four steps from the zero cache: logits, each layer's fp32 conv
    buffer and state (fp32 in the bf16 model too)."""
    jm, params, tm = pair(ARCH, fp32)
    tol = LAYER_TOL if fp32 else dict(rel_to_max=5e-2)
    for _, lj, lt, cj, ct in decode_steps(jm, params, tm, tokens((2, 4), 14), 8):
        assert_logits(lt, lj, fp32, argmax=False)
        assert_trees_close(ct, cj, **tol)
        assert all(c[n].dtype == torch.float32 for c in ct["seg0"]["sub0"]
                   for n in ("conv", "state"))


def test_serve_greedy_ids_match_jax_fp32():
    jm, params, tm = pair(ARCH, fp32=True)
    jb, tb = batch_pair({"tokens": tokens((3, 12), 16)})
    np.testing.assert_array_equal(serve_lm.serve(tm, tb, 5).ids.numpy(),
                                  jax_serve(jm, params, jb, 5))


def test_params_keep_fp32_ssm_leaves():
    _, params, tm = pair(ARCH, fp32=False)
    sd = tm.state_dict()
    for name in ("A_log", "D", "dt_bias"):
        assert sd[f"decoder.seg0.sub0.1.mixer.{name}"].dtype == torch.float32
    assert sd["decoder.seg0.sub0.1.mixer.conv_w"].dtype == torch.bfloat16
    assert not any(".mlp." in k or "norm2" in k for k in sd)
    np.testing.assert_array_equal(to_np(sd["decoder.seg0.sub0.1.mixer.in_proj.w"]),
                                  to_np(params["decoder"]["seg0"]["sub0"]["mixer"]
                                        ["in_proj"]["w"][1]))


def test_decode_matches_prefill():
    """``test_models.py::test_decode_matches_prefill`` for mamba2 on the
    port: cache-by-cache decode reproduces the teacher-forced prefill (bf16:
    equal argmax, log-softmax atol 0.15)."""
    _, _, tm = pair(ARCH, fp32=False)
    tok = torch.from_numpy(tokens((2, 16), 15))
    full = tm.prefill({"tokens": tok})
    cache = tm.make_cache(2, 16)
    for i in range(16):
        logits, cache = tm.decode_step(cache, tok[:, i:i + 1], i)
    lp = torch.log_softmax(full[:, -1].float(), dim=-1)
    ld = torch.log_softmax(logits[:, -1].float(), dim=-1)
    assert torch.equal(lp.argmax(-1), ld.argmax(-1))
    np.testing.assert_allclose(lp.numpy(), ld.numpy(), atol=0.15)


# ---------------------------------------------------------------------------
# test_attention_moe_ssm.py's SSD properties, on the port
# ---------------------------------------------------------------------------


def _ssm_cfgs(chunk=8):
    kw = dict(name="t", family="ssm", n_layers=1, d_model=32, n_heads=0, n_kv_heads=0,
              head_dim=0, d_ff=0, vocab_size=128, compute_dtype="float32",
              param_dtype="float32", ssm_d_state=8, ssm_head_dim=8, ssm_chunk=chunk)
    return JModelConfig(**kw), TModelConfig(**kw)


def _ssm_params(jcfg, seed):
    p = jax.tree.map(np.asarray, JS.make_ssm(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    return jax.tree.map(jnp.asarray, p), ttree(p)


def test_ssd_chunked_equals_sequential():
    """Chunked SSD scan == step-by-step recurrence, each side beside JAX's."""
    jcfg, tcfg = _ssm_cfgs(8)
    pj, pt = _ssm_params(jcfg, 0)
    x = 0.5 * np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 32, 32)))
    y_chunked = TS.ssm_block(pt, tcfg, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(to_np(y_chunked), to_np(JS.ssm_block(
        pj, jcfg, jnp.asarray(x), jnp.float32)), **LAYER_TOL)
    cache = TS.make_ssm_cache(tcfg, 2, "cpu")
    ys = []
    for i in range(32):
        y, cache = TS.ssm_decode_step(pt, tcfg, torch.from_numpy(x[:, i:i + 1]), cache,
                                      torch.float32)
        ys.append(y)
    np.testing.assert_allclose(to_np(torch.cat(ys, 1)), to_np(y_chunked), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("c1,c2", [(4, 16), (8, 32)])
def test_ssd_chunk_size_invariance(c1, c2):
    (j1, t1), (j2, t2) = _ssm_cfgs(c1), _ssm_cfgs(c2)
    pj, pt = _ssm_params(j1, 2)
    x = 0.5 * np.array(jax.random.normal(jax.random.PRNGKey(3), (1, 32, 32)))
    y1 = TS.ssm_block(pt, t1, torch.from_numpy(x), torch.float32)
    y2 = TS.ssm_block(pt, t2, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(to_np(y1), to_np(y2), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(to_np(y2), to_np(JS.ssm_block(pj, j2, jnp.asarray(x),
                                                             jnp.float32)), **LAYER_TOL)


def test_ssd_state_decays():
    """A < 0: with zero input the recurrent state decays monotonically, as
    in JAX's step."""
    jcfg, tcfg = _ssm_cfgs()
    pj, pt = _ssm_params(jcfg, 4)
    cache = TS.make_ssm_cache(tcfg, 1, "cpu")
    cache = {**cache, "state": torch.ones_like(cache["state"])}
    x = torch.zeros((1, 1, 32))
    _, c1 = TS.ssm_decode_step(pt, tcfg, x, cache, torch.float32)
    _, c2 = TS.ssm_decode_step(pt, tcfg, x, c1, torch.float32)
    norms = [float(torch.linalg.norm(c["state"])) for c in (cache, c1, c2)]
    assert norms[1] < norms[0] and norms[2] < norms[1]
    _, cj = JS.ssm_decode_step(pj, jcfg, jnp.zeros((1, 1, 32)),
                               {k: jnp.asarray(v.numpy()) for k, v in cache.items()},
                               jnp.float32)
    np.testing.assert_allclose(c1["state"].numpy(), np.asarray(cj["state"]), **LAYER_TOL)

"""Port parity of the dense-family LM serving path: configs, layers,
attention, prefill, KV-cache decode and the greedy serve loop.

The JAX model is initialised from ``PRNGKey(0)`` and its params carried
across by ``interop.lm_params_from_jax``; inputs are numpy draws fed to both
packages. Smoke configs of ``smollm-135m`` (GQA 4/2 after ``smoke()``, tied
embeddings), ``qwen1.5-0.5b`` (GQA 4/2, QKV bias, tied; and with
``n_kv_heads=4``, G = 1, which reaches K6's MHA contract without the K/V
repeat), ``qwen2-7b`` (untied, bias) and ``phi3-medium-14b`` (untied).

Tolerances and why:
  * layers, fp32: rtol = atol = 1e-5 (fp32 summation order);
  * prefill logits, fp32 configs: max|dlogits| <= 1e-4 * max|logits| (the
    port's K6 plain version against JAX's blockwise XLA attention agree to
    ~1e-6 relative; measured 6e-7 absolute at |logits| ~0.5);
  * prefill logits, bf16 configs: atol 0.02 on logits of magnitude ~0.5
    (a few bf16 ulps: bf16 rounds at other places in the two frameworks, and
    JAX casts p to bf16 before P.V where K6 keeps fp32), tighter than
    ``test_models.py::test_decode_matches_prefill``'s atol 0.15, and equal
    argmax;
  * decode, fp32 configs: logits as prefill; the bf16 caches within one bf16
    ulp (rtol 2^-7, the largest relative size of a bf16 ulp); bf16 configs:
    logits atol 0.02, caches rtol = atol = 2e-2;
  * the port's own decode-matches-prefill property at the JAX test's bar
    (equal argmax, log-softmax atol 0.15);
  * the serve loop's greedy ids in fp32: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs.base import pad_vocab as jpad_vocab
from repro.models import attention as JA
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro_torch import interop
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import SHAPES as TSHAPES
from repro_torch.configs.base import ShapeConfig, pad_vocab
from repro_torch.kernels import counts
from repro_torch.launch import serve_lm
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.models import layers as TL

FP32 = dict(param_dtype="float32", compute_dtype="float32")
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_LOGIT_ATOL = 0.02
#: (arch, overrides) of the smoke configs under test
CASES = {
    "smollm": ("smollm-135m", {}),
    "qwen1.5": ("qwen1.5-0.5b", {}),
    "qwen1.5-mha": ("qwen1.5-0.5b", dict(n_kv_heads=4)),
    "qwen2-untied": ("qwen2-7b", {}),
    "phi3-untied": ("phi3-medium-14b", {}),
}
_PAIRS = {}


def _pair(case, fp32):
    """(JAX model, JAX params, port model) on the same weights."""
    key = (case, fp32)
    if key not in _PAIRS:
        name, kw = CASES[case]
        kw = dict(kw, **FP32) if fp32 else kw
        jcfg = dataclasses.replace(JARCHS[name].smoke(), **kw)
        tcfg = dataclasses.replace(TARCHS[name].smoke(), **kw)
        jm = jbuild(jcfg)
        params = jm.init(jax.random.PRNGKey(0))
        state = interop.lm_params_from_jax(jax.tree.map(np.asarray, params), tcfg)
        _PAIRS[key] = (jm, params, build_model(tcfg, "cpu").load_params(state))
    return _PAIRS[key]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ttree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_configs_resolve_as_in_jax(arch):
    j, t = JARCHS[arch], TARCHS[arch]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.smoke()) == dataclasses.asdict(j.smoke())
    assert t.param_counts() == j.param_counts()
    assert t.vocab_padded == j.vocab_padded


def test_shapes_and_vocab_padding_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in TSHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert pad_vocab(151_936) == jpad_vocab(151_936) == 152_064
    assert pad_vocab(49_152) == 49_152


# ---------------------------------------------------------------------------
# layers, fp32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bias", [False, True])
def test_dense_matches_jax(bias):
    p = {"w": _rand((24, 40), 0)}
    if bias:
        p["b"] = _rand((40,), 1)
    x = _rand((2, 5, 24), 2)
    np.testing.assert_allclose(
        _np(TL.dense(_ttree(p), torch.from_numpy(x), torch.float32)),
        _np(JL.dense(_jtree(p), jnp.asarray(x), jnp.float32)), **LAYER_TOL)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_jax(kind):
    p = {"scale": 1 + 0.1 * _rand((32,), 3)}
    if kind == "layernorm":
        p["bias"] = _rand((32,), 4)
    x = 3 * _rand((2, 7, 32), 5) + 1
    np.testing.assert_allclose(
        _np(TL.norm_apply(_ttree(p), torch.from_numpy(x), 1e-6, torch.float32)),
        _np(JL.norm_apply(_jtree(p), jnp.asarray(x), 1e-6, jnp.float32)), **LAYER_TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_jax(theta):
    """Rotate-half RoPE at positions up to 2047, angles in fp32."""
    x = _rand((2, 9, 3, 16), 6)
    pos = np.stack([np.arange(9), 2047 - np.arange(9)])
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(TL.rope_freqs(16, theta)),
                               _np(JL.rope_freqs(16, theta)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_jax(act):
    p = JL.make_mlp(jax.random.PRNGKey(1), 32, 48, jnp.float32, act=act)
    pn = jax.tree.map(np.asarray, p)
    x = _rand((2, 5, 32), 7)
    np.testing.assert_allclose(
        _np(TL.mlp(_ttree(pn), torch.from_numpy(x), act, torch.float32)),
        _np(JL.mlp(p, jnp.asarray(x), act, jnp.float32)), **LAYER_TOL)


def test_embed_and_unembed_match_jax():
    table = _rand((50, 16), 8)
    tok = _tokens((2, 6), 9) % 50
    x = _rand((2, 6, 16), 10)
    np.testing.assert_array_equal(
        _np(TL.embed({"table": torch.from_numpy(table)}, torch.from_numpy(tok), torch.float32)),
        _np(JL.embed({"table": jnp.asarray(table)}, jnp.asarray(tok), jnp.float32)))
    np.testing.assert_allclose(
        _np(TL.unembed(torch.from_numpy(table), torch.from_numpy(x), torch.float32)),
        _np(JL.unembed(jnp.asarray(table), jnp.asarray(x), jnp.float32)), **LAYER_TOL)


@pytest.mark.parametrize("case", ["smollm", "qwen1.5", "qwen1.5-mha"])
def test_self_attention_matches_jax(case):
    jm, params, tm = _pair(case, fp32=True)
    jp = jax.tree.map(lambda a: a[0], params["decoder"]["seg0"]["sub0"]["mixer"])
    tp = tm.params()["decoder"]["seg0"]["sub0"][0]["mixer"]
    x = _rand((2, 20, tm.cfg.d_model), 11)
    counts.reset()
    got = TA.self_attention(tp, tm.cfg, torch.from_numpy(x), torch.float32)
    assert counts.snapshot() == {"plain:flash_attention": 1}
    want = JA.self_attention(jp, jm.cfg, jnp.asarray(x), jnp.float32)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["smollm", "qwen1.5", "qwen2-untied", "phi3-untied"])
def test_lm_params_roundtrip(case):
    """JAX params -> state dict -> model -> state dict: every leaf of every
    layer equal to JAX's (bf16 exactly), tied/untied and bias keys right."""
    jm, params, tm = _pair(case, fp32=False)
    cfg = tm.cfg
    sd = tm.state_dict()
    assert ("unembed.table" in sd) == (not cfg.tie_embeddings)
    assert any(k.endswith("wq.b") for k in sd) == cfg.qkv_bias
    assert sd["embed.table"].shape == (cfg.vocab_padded, cfg.d_model)
    assert sd["embed.table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(sd["embed.table"]), _np(params["embed"]["table"]))
    stacked = jax.tree_util.tree_leaves_with_path(params["decoder"]["seg0"]["sub0"])
    for path, leaf in stacked:
        name = ".".join(p.key for p in path)
        for r in range(cfg.n_layers):
            np.testing.assert_array_equal(_np(sd[f"decoder.seg0.sub0.{r}.{name}"]),
                                          _np(leaf[r]))
    assert len(sd) == 2 + (not cfg.tie_embeddings) + cfg.n_layers * len(stacked)


def test_lm_params_from_jax_refuses_mismatches():
    jm, params, tm = _pair("smollm", fp32=False)
    p = jax.tree.map(np.asarray, params)
    untied = dataclasses.replace(tm.cfg, tie_embeddings=False)
    with pytest.raises(ValueError, match="tie_embeddings"):
        interop.lm_params_from_jax(p, untied)
    with pytest.raises(ValueError, match="vocab_padded"):
        interop.lm_params_from_jax(p, dataclasses.replace(tm.cfg, vocab_size=300))
    with pytest.raises(ValueError, match="stacked layers"):
        interop.lm_params_from_jax(p, dataclasses.replace(tm.cfg, n_layers=3))
    with pytest.raises(ValueError, match="lack an encoder"):
        interop.lm_params_from_jax(p, TARCHS["whisper-large-v3"].smoke())


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_logits_match_jax_fp32(case):
    jm, params, tm = _pair(case, fp32=True)
    tok = _tokens((2, 24), 12)
    want = _np(jm.prefill(params, {"tokens": jnp.asarray(tok, jnp.int32)}))
    counts.reset()
    got = tm.prefill({"tokens": torch.from_numpy(tok)})
    assert counts.snapshot() == {"plain:flash_attention": tm.cfg.n_layers}
    assert got.shape == (2, 1, tm.cfg.vocab_padded) and got.dtype == torch.float32
    assert np.abs(_np(got) - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("case", ["smollm", "qwen1.5", "qwen1.5-mha", "qwen2-untied"])
def test_prefill_logits_match_jax_bf16(case):
    jm, params, tm = _pair(case, fp32=False)
    tok = _tokens((2, 24), 13)
    want = _np(jm.prefill(params, {"tokens": jnp.asarray(tok, jnp.int32)}))
    got = tm.prefill({"tokens": torch.from_numpy(tok)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=BF16_LOGIT_ATOL)
    np.testing.assert_array_equal(_np(got).argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ["smollm", "qwen1.5", "qwen1.5-mha"])
def test_decode_steps_match_jax(case, fp32):
    """Four decode steps from an empty 8-slot cache: logits and every
    layer's K/V cache after each step."""
    jm, params, tm = _pair(case, fp32=fp32)
    tok = _tokens((2, 4), 14)
    cj, ct = jm.make_cache(2, 8), tm.make_cache(2, 8)
    cache_tol = dict(rtol=2.0 ** -7, atol=1e-6) if fp32 else dict(rtol=2e-2, atol=2e-2)
    for i in range(4):
        lj, cj = jm.decode_step(params, cj, jnp.asarray(tok[:, i:i + 1], jnp.int32),
                                jnp.asarray(i, jnp.int32))
        lt, ct = tm.decode_step(ct, torch.from_numpy(tok[:, i:i + 1]), i)
        lj = _np(lj)
        if fp32:
            assert np.abs(_np(lt) - lj).max() <= 1e-4 * np.abs(lj).max()
        else:
            np.testing.assert_allclose(_np(lt), lj, rtol=0, atol=BF16_LOGIT_ATOL)
        for r in range(tm.cfg.n_layers):
            for n in ("k", "v"):
                got = ct["seg0"]["sub0"][r][n]
                assert got.dtype == torch.bfloat16 and got.shape == (2, 8, tm.cfg.n_kv_heads,
                                                                     tm.cfg.head_dim)
                np.testing.assert_allclose(_np(got), _np(cj["seg0"]["sub0"][r][n]),
                                           **cache_tol)


@pytest.mark.parametrize("case", ["smollm", "qwen1.5"])
def test_port_decode_matches_prefill(case):
    """Cache-by-cache decode reproduces the teacher-forced prefill (bf16,
    the bar of ``test_models.py::test_decode_matches_prefill``)."""
    _, _, tm = _pair(case, fp32=False)
    tok = torch.from_numpy(_tokens((2, 16), 15))
    full = tm.prefill({"tokens": tok})
    cache = tm.make_cache(2, 16)
    for i in range(16):
        logits, cache = tm.decode_step(cache, tok[:, i:i + 1], i)
    lp = torch.log_softmax(full[:, -1].float(), dim=-1)
    ld = torch.log_softmax(logits[:, -1].float(), dim=-1)
    assert torch.equal(lp.argmax(-1), ld.argmax(-1))
    np.testing.assert_allclose(lp.numpy(), ld.numpy(), atol=0.15)


def _jax_serve(jm, params, tokens, gen_len):
    """``repro.launch.serve_lm.main``'s loop on given prompt tokens."""
    b, p = tokens.shape
    logits = jax.jit(jm.prefill)(params, {"tokens": tokens})
    out = [jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)]
    cache = jm.make_cache(b, p + gen_len)
    decode = jax.jit(jm.decode_step)
    for i in range(gen_len):
        logits, cache = decode(params, cache, out[-1], jnp.asarray(p + i, jnp.int32))
        out.append(jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32))
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("case", ["smollm", "qwen1.5"])
def test_serve_greedy_ids_match_jax_fp32(case):
    jm, params, tm = _pair(case, fp32=True)
    tok = _tokens((3, 12), 16)
    want = _jax_serve(jm, params, jnp.asarray(tok, jnp.int32), 6)
    counts.reset()
    res = serve_lm.serve(tm, {"tokens": torch.from_numpy(tok)}, 6)
    assert counts.snapshot() == {"plain:flash_attention": tm.cfg.n_layers}
    assert res.ids.shape == (3, 7)
    np.testing.assert_array_equal(res.ids.numpy(), want)
    assert res.prefill_s > 0 and res.decode_s > 0


def test_input_specs_and_batches():
    _, _, tm = _pair("smollm", fp32=False)
    gen = torch.Generator().manual_seed(0)
    pre = tm.make_batch(gen, ShapeConfig("p", 10, 3, "prefill"))["batch"]
    assert set(pre) == {"tokens"} and pre["tokens"].shape == (3, 10)
    assert int(pre["tokens"].max()) < tm.cfg.vocab_size and pre["tokens"].dtype == torch.int64
    train = tm.make_batch(gen, ShapeConfig("t", 10, 3, "train"))["batch"]
    assert set(train) == {"tokens", "targets"} and train["targets"].shape == (3, 10)
    assert train["targets"].dtype == torch.int64 and int(train["targets"].max()) < 256
    dec = tm.input_specs(ShapeConfig("d", 32, 2, "decode"))
    k = dec["cache"]["seg0"]["sub0"][1]["k"]
    assert k.shape == (2, 32, tm.cfg.n_kv_heads, tm.cfg.head_dim) and k.dtype == torch.bfloat16
    assert len(dec["cache"]["seg0"]["sub0"]) == tm.cfg.n_layers
    assert dec["tokens"].shape == (2, 1) and dec["position"].shape == ()

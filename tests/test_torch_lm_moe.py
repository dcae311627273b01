"""Port parity of the MoE family: ``models/moe.py`` (GShard capacity
dispatch, top-k routing, the aux loss, shared experts) and the moe models
deepseek-moe-16b (a dense first layer, a shared expert) and olmoe-1b-7b
(every layer MoE) at their smoke configs: prefill, decode and serve.

The JAX side runs on the same weights (``PRNGKey(0)`` carried across) and
numpy inputs. fp32: layers rtol = atol = 1e-5, the routing (top indices and
capacity keep masks) equal, logits within 1e-4 * max|logits|, greedy ids
equal; bf16: logits atol 0.02 with equal argmax, caches rtol = atol = 2e-2.
``B * S`` is a multiple of the MoE group (min(128, B * S)), as JAX requires.
The properties of ``test_attention_moe_ssm.py`` are checked on the port,
each beside the JAX function on the same inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.kernels import counts
from repro_torch.launch import serve_lm
from repro_torch.models import moe as TM

from _torch_lm_parity import (LAYER_TOL, assert_logits, assert_trees_close, batch_pair,
                              decode_steps, jax_serve, jitted, layer, pair, rand, to_np,
                              tokens, ttree)

ARCHS = ["deepseek-moe-16b", "olmoe-1b-7b"]
#: JAX's moe_block compiled once per config and shape (fp32; op by op, each
#: primitive compiles on its own and the file takes twice as long)
_jax_moe = jax.jit(JM.moe_block, static_argnums=(1, 3))
#: where the MoE layer's params sit in each smoke config's tree
MOE_PATH = {"deepseek-moe-16b": ("decoder", "seg1", "sub0", "mlp"),
            "olmoe-1b-7b": ("decoder", "seg0", "sub0", "mlp")}


def _jax_routing(p, cfg, xg):
    """``repro.models.moe.moe_block``'s routing lines, on (g, s, d)."""
    e, k = cfg.n_experts, cfg.top_k
    n_groups, group, _ = xg.shape
    logits = JL.dense(p["router"], xg, jnp.float32).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(top_idx, e, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(n_groups, group * k, e), axis=1) - 1.0
    pos_in_e = jnp.sum(pos.reshape(n_groups, group, k, e) * onehot, axis=-1)
    return top_idx, pos_in_e < JM._capacity(group, k, e)


def _moe_pair(arch, skew=0.0):
    """The smoke model's MoE layer params (JAX, port); ``skew`` is added to
    the router's column 0, so that expert 0 takes every token of a positive
    input and overflows its capacity."""
    jm, params, tm = pair(arch, fp32=True)
    pn, _ = layer(params, MOE_PATH[arch])
    pn["router"]["w"] = pn["router"]["w"].copy()
    pn["router"]["w"][:, 0] += skew
    return jm.cfg, tm.cfg, jax.tree.map(jnp.asarray, pn), ttree(pn)


@pytest.mark.parametrize("skew", [0.0, 0.1], ids=["balanced", "skewed"])
@pytest.mark.parametrize("b,s", [(2, 64), (4, 64), (2, 8)])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_and_routing_match_jax(arch, b, s, skew):
    """One group of 128, two groups, one group of 16 tokens; a skewed router
    drops choices past the capacity, in JAX's (token, choice) order."""
    jcfg, tcfg, pj, pt = _moe_pair(arch, skew)
    x = rand((b, s, tcfg.d_model), 1) + (1.0 if skew else 0.0)
    oj, aj = _jax_moe(pj, jcfg, jnp.asarray(x), jnp.float32)
    ot, at = TM.moe_block(pt, tcfg, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(to_np(ot), to_np(oj), **LAYER_TOL)
    np.testing.assert_allclose(float(at), float(aj), **LAYER_TOL)
    group = min(TM.GROUP_SIZE, b * s)
    xg = x.reshape(-1, group, tcfg.d_model)
    idx_j, keep_j = _jax_routing(pj, jcfg, jnp.asarray(xg))
    r = TM.route(pt, tcfg, torch.from_numpy(xg), torch.float32)
    np.testing.assert_array_equal(r.top_idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(keep_j))
    if skew:
        assert not r.keep.all()
    assert TM._capacity(group, tcfg.top_k, tcfg.n_experts) == \
        JM._capacity(group, jcfg.top_k, jcfg.n_experts)


def test_moe_block_refuses_ragged_groups():
    _, tcfg, _, pt = _moe_pair("olmoe-1b-7b")
    with pytest.raises(ValueError, match="multiple of 128"):
        TM.moe_block(pt, tcfg, torch.zeros((3, 50, tcfg.d_model)), torch.float32)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(arch, fp32):
    jm, params, tm = pair(arch, fp32)
    tok = tokens((2, 16), 12)
    want = jitted(jm)[0](params, {"tokens": jnp.asarray(tok, jnp.int32)})
    counts.reset()
    got = tm.prefill({"tokens": torch.from_numpy(tok)})
    assert counts.snapshot() == {"plain:flash_attention": tm.cfg.n_layers}
    assert got.shape == (2, 1, tm.cfg.vocab_padded)
    assert_logits(got, want, fp32)


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, fp32):
    """Four decode steps from an empty 8-slot cache: logits and every
    layer's K/V cache after each step."""
    jm, params, tm = pair(arch, fp32)
    cache_tol = dict(rtol=2.0 ** -7, atol=1e-6) if fp32 else dict(rtol=2e-2, atol=2e-2)
    for _, lj, lt, cj, ct in decode_steps(jm, params, tm, tokens((2, 4), 14), 8):
        assert_logits(lt, lj, fp32, argmax=False)
        assert_trees_close(ct, cj, **cache_tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_greedy_ids_match_jax_fp32(arch):
    jm, params, tm = pair(arch, fp32=True)
    jb, tb = batch_pair({"tokens": tokens((2, 16), 16)})
    want = jax_serve(jm, params, jb, 4)
    counts.reset()
    res = serve_lm.serve(tm, tb, 4)
    assert counts.snapshot() == {"plain:flash_attention": tm.cfg.n_layers}
    np.testing.assert_array_equal(res.ids.numpy(), want)


def test_params_layout_and_dtypes():
    """deepseek's smoke tree: a dense layer 0 (d_ff), then MoE layers with
    (e, d, f) expert stacks and one shared expert of moe_d_ff."""
    _, params, tm = pair("deepseek-moe-16b", fp32=False)
    sd = tm.state_dict()
    cfg = tm.cfg
    assert sd["decoder.seg0.sub0.0.mlp.gate.w"].shape == (cfg.d_model, cfg.d_ff)
    assert sd["decoder.seg1.sub0.0.mlp.gate"].shape == (cfg.n_experts, cfg.d_model,
                                                         cfg.moe_d_ff)
    assert sd["decoder.seg1.sub0.0.mlp.shared.up.w"].shape == (
        cfg.d_model, cfg.n_shared_experts * cfg.moe_d_ff)
    assert all(t.dtype == torch.bfloat16 for t in sd.values())
    np.testing.assert_array_equal(
        to_np(sd["decoder.seg1.sub0.0.mlp.down"]),
        to_np(params["decoder"]["seg1"]["sub0"]["mlp"]["down"][0]))


# ---------------------------------------------------------------------------
# test_attention_moe_ssm.py's MoE properties, on the port beside JAX
# ---------------------------------------------------------------------------


def _tiny(**kw):
    base = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
                head_dim=8, d_ff=64, vocab_size=128, compute_dtype="float32",
                param_dtype="float32", n_experts=8, top_k=2, moe_d_ff=32)
    base.update(kw)
    return JModelConfig(**base), TModelConfig(**base)


def _both(jcfg, tcfg, seed, x_shape, x_seed, **edit):
    p = jax.tree.map(np.asarray, JM.make_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    p.update(edit)
    x = np.array(jax.random.normal(jax.random.PRNGKey(x_seed), x_shape))
    oj, aj = _jax_moe(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x), jnp.float32)
    ot, at = TM.moe_block(ttree(p), tcfg, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(to_np(ot), to_np(oj), **LAYER_TOL)
    np.testing.assert_allclose(float(at), float(aj), **LAYER_TOL)
    return p, x, ot, at


def test_moe_router_weights_normalized():
    jcfg, tcfg = _tiny()
    p, x, out, aux = _both(jcfg, tcfg, 0, (2, 16, 32), 1)
    assert out.shape == x.shape and torch.isfinite(aux) and float(aux) > 0.0
    r = TM.route(ttree(p), tcfg, torch.from_numpy(x).reshape(1, 32, 32), torch.float32)
    torch.testing.assert_close(r.top_p.sum(-1), torch.ones((1, 32)))


def test_moe_aux_loss_uniform_router_is_k_over_e():
    """Every expert ties: aux = k/e, and the lower indices win, as in JAX."""
    jcfg, tcfg = _tiny()
    p, x, _, aux = _both(jcfg, tcfg, 0, (4, 32, 32), 1, router={"w": np.zeros((32, 8),
                                                                             np.float32)})
    assert abs(float(aux) - tcfg.top_k / tcfg.n_experts) < 1e-5
    r = TM.route(ttree(p), tcfg, torch.from_numpy(x).reshape(1, 128, 32), torch.float32)
    assert (r.top_idx == torch.tensor([0, 1])).all()


def test_moe_capacity_drops_are_bounded():
    jcfg, tcfg = _tiny()
    _, _, out, _ = _both(jcfg, tcfg, 2, (2, 64, 32), 3)
    nonzero = float((out.abs() > 1e-7).any(dim=-1).float().mean())
    assert nonzero > 0.6


def test_moe_shared_expert_always_active():
    jcfg, tcfg = _tiny(n_shared_experts=1)
    p, _, _, _ = _both(jcfg, tcfg, 4, (1, 8, 32), 5)
    _, _, out2, _ = _both(jcfg, tcfg, 4, (1, 8, 32), 5, down=np.zeros_like(p["down"]))
    assert float(out2.abs().max()) > 1e-6


def test_smoke_config_routing_is_the_published_shape():
    """The smoke configs keep their family's routing shape: top-2 of 4."""
    for arch in ARCHS:
        _, _, tm = pair(arch, fp32=True)
        assert (tm.cfg.n_experts, tm.cfg.top_k) == (4, 2)
        assert dataclasses.asdict(tm.cfg)["family"] == "moe"

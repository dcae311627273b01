"""Port parity of the training forward and its gradients, dense, vlm and
encdec families: ``layers.softmax_xent``, the blockwise self-attention with
its gradients, and ``Model.loss`` with every gradient leaf against
``jax.jit(jax.value_and_grad(Model.loss, has_aux=True))`` on the same
weights (``Model.init(PRNGKey(0))``) and numpy batches.

Tolerances: ``softmax_xent`` and its gradient rtol 1e-6 (fp32); blockwise
attention outputs and q/k/v gradients within 1e-5 * max|JAX| (fp32 sums in
another order); fp32 loss and xent rtol 1e-5, aux rtol 1e-5, each gradient
leaf within 1e-4 * max|JAX leaf|; bf16 loss within 0.02 of JAX run op by op
(XLA keeps excess precision inside ``jit``'s fusions) and finite gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch.kernels import counts
from repro_torch.kernels import flashattn as FA
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL

from _torch_lm_parity import (BF16_LOSS_ATOL, assert_grads_close, assert_loss_close,
                              batch_pair, jax_value_and_grad, pair, port_loss_and_grads,
                              rand, to_np, train_batch)

torch.set_num_threads(1)

#: arch -> (batch, sequence) of its loss case; smollm also at S = 1024, where
#: self-attention runs two 512-query blocks over three causal KV chunks
CASES = {"smollm-135m": (2, 64), "smollm-135m-s1024": (1, 1024), "qwen2-7b": (2, 64),
         "internvl2-1b": (2, 40), "whisper-large-v3": (2, 64)}


def _arch(case):
    return case.split("-s")[0] if case.endswith("s1024") else case


@pytest.fixture(scope="module")
def fp32_results():
    """One jitted JAX value_and_grad per case, computed once for the module."""
    out = {}
    for case, (b, s) in CASES.items():
        jm, params, tm = pair(_arch(case), True)
        bn = train_batch(jm, b, s, seed=3)
        jb, tb = batch_pair(bn, bf16_floats=False)
        (jl, jmet), jg = jax_value_and_grad(jm)(params, jb)
        out[case] = (jl, jmet, jg, tm, params, tb)
    return out


def test_softmax_xent_with_padded_vocab():
    logits = rand((3, 5, 40), 1, scale=3.0)
    targets = np.random.default_rng(2).integers(0, 33, (3, 5))
    jfn = jax.value_and_grad(lambda x: JL.softmax_xent(x, jnp.asarray(targets), 33))
    jv, jg = jfn(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    tv = TL.softmax_xent(x, torch.from_numpy(targets), 33)
    tv.backward()
    assert tv.dtype == torch.float32
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-9)
    assert float(x.grad[..., 33:].abs().max()) == 0.0  # the padded tail takes no mass
    tb = TL.softmax_xent(torch.from_numpy(logits).to(torch.bfloat16),
                         torch.from_numpy(targets).to(torch.int32), 33)
    np.testing.assert_allclose(float(tb), float(JL.softmax_xent(
        jnp.asarray(logits, jnp.bfloat16), jnp.asarray(targets, jnp.int32), 33)), rtol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,q_block,kv_chunk,steps", [
    (48, 16, 8, {True: 12, False: 18}),    # 3 q blocks x 2-6 (causal) or 6 chunks
    (40, 16, 8, {True: 5, False: 5}),      # 16 does not divide 40: one block, 5 chunks
    (36, 12, 8, {True: 12, False: 18})])   # chunks of 6: the largest <= 8 tiling 36 and 12
def test_blockwise_attention_and_grads_match_jax(monkeypatch, s, q_block, kv_chunk, steps,
                                                 causal):
    b, n_kv, g, hd = 2, 2, 2, 16
    q, k, v = (rand((b, s, n_kv, g, hd), 1), rand((b, s, n_kv, hd), 2),
               rand((b, s, n_kv, hd), 3))
    ct = rand((b, s, n_kv, g, hd), 4)
    JA.set_block_config(q_block=q_block, kv_chunk=kv_chunk)
    TA.set_block_config(q_block=q_block, kv_chunk=kv_chunk)
    try:
        def jloss(q, k, v):
            out = JA.multihead_attention(q, k, v, causal)
            return jnp.sum(out * ct), out

        (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        calls = []
        step = TA._chunk_step
        monkeypatch.setattr(TA, "_chunk_step", lambda *a: calls.append(1) or step(*a))
        tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
        tout = TA.blockwise_attention(tq, tk, tv, causal)
        assert len(calls) == steps[causal]
        (tout * torch.from_numpy(ct)).sum().backward()
        assert len(calls) == 2 * steps[causal]  # every chunk step recomputed once
    finally:
        JA.reset_block_config()
        TA.reset_block_config()
    assert tout.dtype == torch.float32
    jout = np.asarray(jout)
    assert np.abs(tout.detach().numpy() - jout).max() <= 1e-5 * np.abs(jout).max()
    for t, w in zip((tq, tk, tv), jg):
        w = np.asarray(w)
        assert np.abs(t.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_block_config_set_and_reset():
    TA.set_block_config(q_block=32, score_dtype=torch.bfloat16)
    assert TA._BLOCK_CONFIG == {"q_block": 32, "kv_chunk": 512,
                                "score_dtype": torch.bfloat16}
    TA.set_block_config(kv_chunk=16)
    assert TA._BLOCK_CONFIG["kv_chunk"] == 16 and TA._BLOCK_CONFIG["q_block"] == 32
    TA.reset_block_config()
    assert TA._BLOCK_CONFIG == {"q_block": 512, "kv_chunk": 512, "score_dtype": None}


def test_bf16_scores_match_jax():
    """``REPRO_SCORE_BF16``'s score dtype on both sides, bf16 q/k/v."""
    q, k, v = (rand((1, 64, 2, 2, 16), 5), rand((1, 64, 2, 16), 6), rand((1, 64, 2, 16), 7))
    JA.set_block_config(q_block=32, kv_chunk=16, score_dtype=jnp.bfloat16)
    TA.set_block_config(q_block=32, kv_chunk=16, score_dtype=torch.bfloat16)
    try:
        want = JA.multihead_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                      True)
        got = TA.blockwise_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                                       for x in (q, k, v)), True)
    finally:
        JA.reset_block_config()
        TA.reset_block_config()
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=0, atol=0.02)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fp32_loss_and_grads_match_jax(fp32_results, case):
    jl, jmet, jg, tm, params, tb = fp32_results[case]
    counts.reset()
    tl, tmet, tg = port_loss_and_grads(tm, params, tb)
    assert "plain:flash_attention" not in counts.snapshot()  # no K6 on the loss path
    assert_loss_close(tl, tmet, jl, jmet)
    assert_grads_close(tg, jg)


@pytest.mark.parametrize("arch", ["smollm-135m", "internvl2-1b", "whisper-large-v3"])
def test_bf16_loss_matches_jax_op_by_op(arch):
    jm, params, tm = pair(arch, False)
    assert tm.cfg.compute_dtype == "bfloat16"
    jb, tb = batch_pair(train_batch(jm, 2, 64, seed=4))
    (jl, _), _ = jax_value_and_grad(jm)(params, jb)
    tl, _, tg = port_loss_and_grads(tm, params, tb)
    assert abs(float(tl.detach()) - float(jl)) <= BF16_LOSS_ATOL
    for g in tg:
        assert g.dtype in (torch.bfloat16, torch.float32)
        assert bool(torch.isfinite(g.float()).all())


def test_k6_refuses_gradients():
    q, k, v = (torch.randn((2, 8, 16), generator=torch.Generator().manual_seed(i))
               for i in range(3))
    with pytest.raises(RuntimeError, match="no backward"):
        FA.flash_attention(q.requires_grad_(True), k, v, causal=True)
    with torch.no_grad():
        FA.flash_attention(q, k, v, causal=True)  # no autograd: the plain version runs

"""Port parity of the training forward and its gradients, MoE, SSM and
hybrid families: ``Model.loss`` with every gradient leaf against
``jax.jit(jax.value_and_grad(Model.loss, has_aux=True))`` on the same
weights and numpy batches; the MoE block's gradients where the capacity
drops choices (through ``top_p``, the keep mask and the router's ``probs``
in the aux loss), and the SSD block's through the state carried across
chunks.

Tolerances as ``test_torch_train_loss.py``: fp32 loss, xent and aux rtol
1e-5; each gradient leaf within 1e-4 * max|JAX leaf|; bf16 loss within 0.02
of JAX run op by op and finite gradients. B * S is a multiple of the MoE's
128-token routing group, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro.models import ssm as JS
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS

from _torch_lm_parity import (BF16_LOSS_ATOL, GRAD_REL, assert_grads_close,
                              assert_loss_close, batch_pair, jax_value_and_grad, layer, pair,
                              port_loss_and_grads, rand, ttree, train_batch)

torch.set_num_threads(1)

ARCHS = ["olmoe-1b-7b", "deepseek-moe-16b", "mamba2-780m", "jamba-v0.1-52b"]
#: where an MoE layer's params sit in each MoE smoke config's tree
MOE_PATH = {"deepseek-moe-16b": ("decoder", "seg1", "sub0", "mlp"),
            "olmoe-1b-7b": ("decoder", "seg0", "sub0", "mlp")}


@pytest.fixture(scope="module")
def fp32_results():
    """One jitted JAX value_and_grad per arch, computed once for the module."""
    out = {}
    for arch in ARCHS:
        jm, params, tm = pair(arch, True)
        jb, tb = batch_pair(train_batch(jm, 2, 64, seed=5), bf16_floats=False)
        (jl, jmet), jg = jax_value_and_grad(jm)(params, jb)
        out[arch] = (jl, jmet, jg, tm, params, tb)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_loss_and_grads_match_jax(fp32_results, arch):
    jl, jmet, jg, tm, params, tb = fp32_results[arch]
    if tm.cfg.family in ("ssm", "hybrid"):
        assert tb["tokens"].shape[1] // tm.cfg.ssm_chunk >= 2  # the state crosses chunks
    tl, tmet, tg = port_loss_and_grads(tm, params, tb)
    if tm.cfg.n_experts:
        assert float(tmet["aux"].detach()) > 0
    assert_loss_close(tl, tmet, jl, jmet)
    assert_grads_close(tg, jg)


@pytest.mark.parametrize("arch", sorted(MOE_PATH))
def test_moe_block_grads_with_capacity_drops_match_jax(arch):
    """Expert 0's router column skewed so that it overflows its capacity:
    gradients of sum(out * ct) + 0.01 * aux for every MoE param and the input."""
    jm, params, tm = pair(arch, True)
    pn, _ = layer(params, MOE_PATH[arch])
    pn["router"]["w"] = pn["router"]["w"].copy()
    pn["router"]["w"][:, 0] += 0.1
    x = rand((2, 64, tm.cfg.d_model), 1) + 1.0
    ct = rand((2, 64, tm.cfg.d_model), 2)

    def jloss(p, x):
        out, aux = JM.moe_block(p, jm.cfg, x, jnp.float32)
        return jnp.sum(out * ct) + 0.01 * aux

    jv, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, pn), jnp.asarray(x))
    pt = jax.tree.map(lambda t: t.requires_grad_(True), ttree(pn))
    xt = torch.from_numpy(x).requires_grad_(True)
    r = TM.route(pt, tm.cfg, xt.detach().reshape(1, 128, -1), torch.float32)
    assert not bool(r.keep.all())  # choices dropped at the capacity
    out, aux = TM.moe_block(pt, tm.cfg, xt, torch.float32)
    tv = (out * torch.from_numpy(ct)).sum() + 0.01 * aux
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    assert float(pt["router"]["w"].grad.abs().max()) > 0
    assert_grads_close([t.grad for t in jax.tree.leaves(pt)] + [xt.grad], [jgp, jgx])


def test_ssm_block_grads_across_three_chunks_match_jax():
    jm, params, tm = pair("mamba2-780m", True)
    pn, _ = layer(params, ("decoder", "seg0", "sub0", "mixer"))
    s = 3 * tm.cfg.ssm_chunk
    x = rand((2, s, tm.cfg.d_model), 3)
    ct = rand((2, s, tm.cfg.d_model), 4)

    def jloss(p, x):
        return jnp.sum(JS.ssm_block(p, jm.cfg, x, jnp.float32) * ct)

    jv, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, pn), jnp.asarray(x))
    pt = jax.tree.map(lambda t: t.requires_grad_(True), ttree(pn))
    xt = torch.from_numpy(x).requires_grad_(True)
    tv = (TS.ssm_block(pt, tm.cfg, xt, torch.float32) * torch.from_numpy(ct)).sum()
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    assert float(pt["A_log"].grad.abs().max()) > 0  # the decay learns through the state
    assert_grads_close([t.grad for t in jax.tree.leaves(pt)] + [xt.grad], [jgp, jgx],
                       GRAD_REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_jax_op_by_op(arch):
    jm, params, tm = pair(arch, False)
    assert tm.cfg.compute_dtype == "bfloat16"
    jb, tb = batch_pair(train_batch(jm, 2, 64, seed=6))
    (jl, _), _ = jax_value_and_grad(jm)(params, jb)
    tl, _, tg = port_loss_and_grads(tm, params, tb)
    assert abs(float(tl.detach()) - float(jl)) <= BF16_LOSS_ATOL
    assert all(bool(torch.isfinite(g.float()).all()) for g in tg)

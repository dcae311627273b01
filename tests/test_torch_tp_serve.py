"""The sharded prefill and decode steps (``repro_torch.train.steps.
make_prefill_step`` / ``make_decode_step``) on meshes with a ``model``
axis: each rank serves from its ``param_specs`` blocks and its
``cache_specs`` blocks of the decode cache.

One world of 4 gloo ranks (``tests/_torch_tp_ranks.py``, in a subprocess
with a timeout) runs the cases of ``test_torch_tp_train.py`` (the smoke
configs of smollm-135m, deepseek-moe-16b, mamba2-780m and jamba-v0.1-52b
on (1, 2), (1, 4), (2, 2) and (2, 2, 1); whisper-large-v3 and internvl2-1b
on (1, 2)), in fp32:
a prefill of 4 prompts, then 4 decode steps of 8 requests (512 for a MoE
model: a whole 128-token group on each of four data ranks) into a random
fp32 cache of 16 slots from position 6, so the new tokens' slots cross a
block boundary at m = 2 and m = 4. Each case is held to the port's
unsharded ``Model.prefill`` / ``decode_step`` and to JAX's (one jitted
function an arch: the prefill and the four decode steps) on the same
weights:

* the prefill's logits (whole on every rank) within 1e-4 * max, with equal
  greedy ids;
* each decode step's logits within 1e-4 * max, with equal ids;
* the gathered cache within 1e-5 * max of the unsharded one, leaf by leaf.

smollm also runs on (1, 2) and (1, 4) with the residual stream whole on
every rank (``REPRO_RESIDUAL_SEQ=0``), through the same checks.

Also: smollm on (1, 4) with the served bf16 KV cache against the unsharded
decode on it (the repo's bf16 logit check: atol 0.02, equal ids); a MoE
decode whose rows split its token group over the data axes raises
``ValueError``.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild
from repro_torch.optim import adamw as TO

import _torch_tp_ranks as W
from _torch_lm_parity import BF16_LOGIT_ATOL

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
LOGIT_REL, CACHE_REL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_serve") / "out.pt"
    script = (f"import sys; sys.path.insert(0, {str(ROOT / 'tests')!r}); "
              f"import _torch_tp_ranks as W; W.main('serve', {str(out)!r})")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, f"stderr:\n{res.stderr}\nstdout:\n{res.stdout}"
    return torch.load(out, weights_only=False)


def _port(arch, inputs, bf16_cache=False):
    """The port's unsharded prefill logits, decode logits and final cache."""
    model = W.model_of(arch)
    W.params_of(model)
    batch, toks, cache_np = inputs
    with torch.inference_mode():
        pre = model.prefill(W.tensors(batch))
        cache = W.cache_tree(model, cache_np)
        if bf16_cache:
            cache = TO.unflatten(cache, [t.bfloat16() for t in TO.leaves(cache)])
        steps = []
        for i in range(W.DECODE_STEPS):
            lg, cache = model.decode_step(cache, torch.from_numpy(toks[:, i:i + 1]),
                                          W.DECODE_FROM + i)
            steps.append(lg)
    return dict(prefill=pre, decode=steps, cache=TO.leaves(cache))


def _jax(arch, inputs):
    """JAX's prefill and decode steps on the same weights, one jitted
    function."""
    model = W.model_of(arch)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), W.params_of(model))
    jm = jbuild(dataclasses.replace(JARCHS[arch].smoke(), **W.FP32))
    batch, toks, cache_np = inputs
    cfg = jm.cfg
    tree = jax.tree.structure(jm.make_cache(W.decode_batch(model), W.CACHE_SEQ))
    cache = jax.tree.unflatten(tree, [jnp.asarray(a) for a in cache_np])

    def run(params, batch, cache, toks):
        pre = jm.prefill(params, batch)
        steps = []
        for i in range(W.DECODE_STEPS):
            lg, cache = jm.decode_step(params, cache, toks[:, i:i + 1],
                                       jnp.asarray(W.DECODE_FROM + i, jnp.int32))
            steps.append(lg)
        return pre, steps

    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jnp.float32)
          for k, v in batch.items()}
    pre, steps = jax.jit(run)(params, jb, cache, jnp.asarray(toks, jnp.int32))
    assert cfg.compute_dtype == "float32"
    return dict(prefill=np.asarray(pre), decode=[np.asarray(s) for s in steps])


@pytest.fixture(scope="module")
def refs(world):
    return {}


def _ref(refs, world, arch):
    if arch not in refs:
        inputs = world["inputs"][arch]
        refs[arch] = (_port(arch, inputs), _jax(arch, inputs))
    return refs[arch]


def _logits_close(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = want.float().numpy() if isinstance(want, torch.Tensor) else want
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOGIT_REL * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("case", W.SERVE_CASES, ids=W.case_id)
def test_sharded_prefill_and_decode_match_the_unsharded_ones(world, refs, case):
    got = world["ranks"][0]["cases"][W.case_id(case)]
    port, jx = _ref(refs, world, case[0])
    for want in (port, jx):
        _logits_close(got["prefill"], want["prefill"])
        assert len(got["decode"]) == W.DECODE_STEPS
        for g, w in zip(got["decode"], want["decode"]):
            _logits_close(g, w)
    assert len(got["cache"]) == len(port["cache"])
    for g, w in zip(got["cache"], port["cache"]):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert float((g - w).abs().max()) <= CACHE_REL * float(w.abs().max())


def test_sharded_decode_on_the_served_bf16_cache(world):
    """bf16 K/V (as served): a value that the column blocks' products round
    to the other bf16 neighbour moves the logits by up to ~2e-3 * max, so the
    repo's bf16 logit check holds (atol 0.02, equal ids)."""
    got = world["ranks"][0]["bf16_cache"]
    want = _port("smollm-135m", world["inputs"]["smollm-135m"], bf16_cache=True)
    for g, w in zip(got["decode"], want["decode"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=BF16_LOGIT_ATOL)
        np.testing.assert_array_equal(g.argmax(-1).numpy(), w.argmax(-1).numpy())
    for g, w in zip(got["cache"], want["cache"]):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), rtol=2.0 ** -7,
                                   atol=1e-6)


def test_a_moe_decode_that_regroups_the_tokens_raises(world):
    msg = world["ranks"][0]["moe_refusal"]
    assert msg is not None and "groups of 4" in msg

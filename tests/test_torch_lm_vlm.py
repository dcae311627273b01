"""Port parity of the vlm family: internvl2-1b's smoke config (8 patch
embeddings in front of the text, GQA 4/2, QKV bias, tied embeddings):
inputs, prefill, decode and serve.

The JAX side runs on the same weights (``PRNGKey(0)`` carried across) and
numpy inputs (patches given in bf16, as ``make_batch`` gives them). fp32:
logits within 1e-4 * max|logits|, the bf16 K/V caches within one bf16 ulp
(rtol 2^-7), greedy ids equal; bf16: logits atol 0.02 (prefill also equal
argmax), caches rtol = atol = 2e-2.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import counts
from repro_torch.launch import serve_lm

from _torch_lm_parity import (assert_logits, assert_trees_close, batch_pair, decode_steps,
                              jax_serve, jitted, pair, rand, tokens)

ARCH = "internvl2-1b"


def _batch(tm, b, text, seed):
    return batch_pair({"patches": rand((b, tm.cfg.n_patches, tm.cfg.d_model), seed),
                       "tokens": tokens((b, text), seed + 1)})


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_prefill_logits_match_jax(fp32):
    jm, params, tm = pair(ARCH, fp32)
    jb, tb = _batch(tm, 2, 16, 12)
    want = jitted(jm)[0](params, jb)
    counts.reset()
    got = tm.prefill(tb)
    assert counts.snapshot() == {"plain:flash_attention": tm.cfg.n_layers}
    assert got.shape == (2, 1, tm.cfg.vocab_padded)
    assert_logits(got, want, fp32)


def test_patches_change_the_text_logits():
    """The patches sit in front of the text: other patches, other logits."""
    _, _, tm = pair(ARCH, fp32=True)
    _, tb = _batch(tm, 2, 16, 12)
    other = dict(tb, patches=tb["patches"] + 1)
    assert not torch.allclose(tm.prefill(tb), tm.prefill(other))


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_decode_steps_match_jax(fp32):
    jm, params, tm = pair(ARCH, fp32)
    tol = dict(rtol=2.0 ** -7, atol=1e-6) if fp32 else dict(rtol=2e-2, atol=2e-2)
    for _, lj, lt, cj, ct in decode_steps(jm, params, tm, tokens((2, 4), 14), 32, start=24):
        assert_logits(lt, lj, fp32, argmax=False)
        assert_trees_close(ct, cj, **tol)


def test_serve_greedy_ids_match_jax_fp32():
    """Decode starts at patches + text tokens, as in JAX's launcher."""
    jm, params, tm = pair(ARCH, fp32=True)
    jb, tb = _batch(tm, 3, 12, 16)
    assert serve_lm.prompt_len(tb) == tm.cfg.n_patches + 12
    np.testing.assert_array_equal(serve_lm.serve(tm, tb, 5).ids.numpy(),
                                  jax_serve(jm, params, jb, 5))


def test_vlm_patch_text_split():
    """``test_models.py::test_vlm_patch_text_split`` on the port's inputs:
    n_patches patches of d_model, S - n_patches text tokens; finite logits."""
    _, _, tm = pair(ARCH, fp32=False)
    batch = tm.make_batch(torch.Generator().manual_seed(1),
                          ShapeConfig("t", 64, 2, "prefill"))["batch"]
    assert batch["patches"].shape == (2, tm.cfg.n_patches, tm.cfg.d_model)
    assert batch["patches"].dtype == torch.bfloat16
    assert batch["tokens"].shape == (2, 64 - tm.cfg.n_patches)
    assert tm.text_len(64) == 64 - tm.cfg.n_patches
    assert torch.isfinite(tm.prefill(batch).float()).all()

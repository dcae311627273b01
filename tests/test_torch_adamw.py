"""Port parity of AdamW (``repro_torch.optim.adamw`` against
``repro.optim.adamw``), JAX run op by op on the same numpy trees.

Tolerances: the schedule, ``grad_norm`` and ``lr`` within rtol 1e-6 (fp32,
libm's cos and pow against XLA's, and the norm's sums in another order);
after each of three updates ``m``, ``v`` and ``master`` within rtol 1e-6
elementwise, plus 1e-6 * max|leaf| absolute (a master element that the step
nearly cancels carries the last-ulp difference of ``lr`` or of the clip
scale at the leaf's scale, measured 9.3e-10 at max|leaf| 0.025), the fp32 params (the master)
likewise, and the bf16 params equal. Where the clip is inactive every leaf
comes out bit-equal: the update's arithmetic is the same fp32 IEEE ops in the
same order, and only the norm's per-leaf sums run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as J
from repro_torch.optim import adamw as T

CFG = T.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)


def _jcfg(cfg):
    return J.AdamWConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


@pytest.mark.parametrize("step", [0, 1, 2, 3, 5, 9, 10, 11, 1000])
@pytest.mark.parametrize("warmup,total", [(2, 10), (0, 10), (100, 10_000), (5, 5)])
def test_cosine_schedule_matches_jax(step, warmup, total):
    cfg = T.AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    got = T.cosine_schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = np.asarray(J.cosine_schedule(_jcfg(cfg), jnp.asarray(step, jnp.int32)))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _tree(rng, scale=1.0):
    """A tree in insertion order unlike its sorted order: bf16 and fp32
    leaves, nested dicts and a list."""
    def a(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"w": a(4, 6), "b": {"z": a(5), "a": a(3, 2)}, "blocks": [a(2, 3), a(7)],
            "norm": a(6)}


_BF16 = {"w", "z"}


def _cast(tree, to_leaf, path=""):
    if isinstance(tree, dict):
        return {k: _cast(v, to_leaf, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, to_leaf, path) for v in tree]
    return to_leaf(tree, path in _BF16)


def _jleaf(a, bf16):
    return jnp.asarray(a).astype(jnp.bfloat16 if bf16 else jnp.float32)


def _tleaf(a, bf16):
    return torch.from_numpy(a).to(torch.bfloat16 if bf16 else torch.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def test_leaves_follow_jax_order():
    tree = _tree(np.random.default_rng(0))
    got = T.leaves(_cast(tree, _tleaf))
    want = jax.tree.leaves(_cast(tree, _jleaf))
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    for t, w in zip(got, want):
        np.testing.assert_array_equal(_np(t), _np(w))
    flat = [t * 2 for t in got]
    rebuilt = T.unflatten(_cast(tree, _tleaf), flat)
    assert list(rebuilt) == list(tree) and list(rebuilt["b"]) == ["z", "a"]
    assert all(x is y for x, y in zip(T.leaves(rebuilt), flat))


@pytest.mark.parametrize("grad_scale,clipped", [(10.0, True), (0.01, False)],
                         ids=["clip-active", "clip-inactive"])
def test_three_updates_match_jax(grad_scale, clipped):
    rng = np.random.default_rng(1)
    params_np = _tree(rng)
    jp, tp = _cast(params_np, _jleaf), _cast(params_np, _tleaf)
    jo, to = J.adamw_init(jp), T.adamw_init(tp)
    assert to["step"].dtype == torch.int32 and int(to["step"]) == 0
    jcfg = _jcfg(CFG)
    for step in range(1, 4):
        grads_np = _tree(rng, grad_scale)
        jp, jo, jm = J.adamw_update(jcfg, _cast(grads_np, _jleaf), jo, jp)
        tp, to, tm = T.adamw_update(CFG, _cast(grads_np, _tleaf), to, tp)
        assert int(to["step"]) == step
        assert (float(tm["grad_norm"]) > CFG.grad_clip) == clipped
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(_np(tm[key]), _np(jm[key]), rtol=1e-6, atol=0)
        for key in ("m", "v", "master"):
            for t, w in zip(T.leaves(to[key]), jax.tree.leaves(jo[key])):
                assert t.dtype == torch.float32
                w = np.asarray(w)
                np.testing.assert_allclose(t.numpy(), w, rtol=1e-6,
                                           atol=1e-6 * np.abs(w).max())
                if not clipped:
                    np.testing.assert_array_equal(t.numpy(), w)
        for t, w in zip(T.leaves(tp), jax.tree.leaves(jp)):
            assert str(t.dtype).split(".")[-1] == str(w.dtype)
            if t.dtype == torch.bfloat16:
                np.testing.assert_array_equal(_np(t), _np(w))
            else:  # the fp32 master itself
                np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6,
                                           atol=1e-6 * np.abs(np.asarray(w)).max())


def test_global_norm_matches_jax():
    tree = _tree(np.random.default_rng(2), 3.0)
    got = T.global_norm(_cast(tree, _tleaf))
    want = J.global_norm(_cast(tree, _jleaf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)

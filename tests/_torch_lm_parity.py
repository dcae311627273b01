"""Shared helpers of the LM family parity files (``test_torch_lm_*.py``):
a JAX model and the port's model on the same weights (JAX ``Model.init(
PRNGKey(0))`` carried across by ``interop.lm_params_from_jax``), numpy
inputs for both, and the JAX serve loop of ``repro.launch.serve_lm``.

Tolerances, as in ``test_torch_lm.py``: layers fp32 rtol = atol = 1e-5;
fp32 logits within 1e-4 * max|logits|; bf16 logits atol 0.02 and equal
argmax. bf16 models are held against JAX run op by op (not jitted), which
rounds at the points the port rounds: under ``jit`` XLA keeps excess
precision inside its fusions, and on the olmoe smoke config that alone moved
one decode step's bf16 logits by 0.178 (an expert choice flips).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild
from repro_torch import interop
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.models import build_model

FP32 = dict(param_dtype="float32", compute_dtype="float32")
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_LOGIT_ATOL = 0.02
_PAIRS = {}
_JITS = {}


def pair(arch, fp32, **overrides):
    """(JAX model, JAX params, port model on the CPU) of ``arch``'s smoke
    config, fp32 or as published (bf16), with ``overrides``."""
    key = (arch, fp32, tuple(sorted(overrides.items())))
    if key not in _PAIRS:
        kw = dict(overrides, **FP32) if fp32 else overrides
        jcfg = dataclasses.replace(JARCHS[arch].smoke(), **kw)
        tcfg = dataclasses.replace(TARCHS[arch].smoke(), **kw)
        jm = jbuild(jcfg)
        params = jm.init(jax.random.PRNGKey(0))
        state = interop.lm_params_from_jax(jax.tree.map(np.asarray, params), tcfg)
        _PAIRS[key] = (jm, params, build_model(tcfg, "cpu").load_params(state))
    return _PAIRS[key]


def jitted(jm):
    """(prefill, decode_step) of one JAX model: jitted (compiled once per
    model and input shape) for fp32 models, op by op for bf16 ones."""
    if id(jm) not in _JITS:
        fns = (jm.prefill, jm.decode_step)
        if jm.cfg.compute_dtype == "float32":
            fns = tuple(jax.jit(f) for f in fns)
        _JITS[id(jm)] = (jm,) + fns
    return _JITS[id(jm)][1:]


def rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def tokens(shape, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def to_np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def ttree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def layer(params, path, r=0):
    """Layer r's params of a stacked JAX segment, as numpy, and as JAX arrays."""
    sub = params
    for k in path:
        sub = sub[k]
    sub = jax.tree.map(lambda a: np.asarray(a[r]), sub)
    return sub, jtree(sub)


def batch_pair(batch_np, bf16_floats=True):
    """A numpy batch as (JAX batch, port batch); float inputs in bf16 as
    ``make_batch`` gives them (fp32 for fp32 models when ``bf16_floats`` is
    False)."""
    jb, tb = {}, {}
    for k, v in batch_np.items():
        if v.dtype.kind == "f":
            jb[k] = jnp.asarray(v, jnp.bfloat16 if bf16_floats else jnp.float32)
            tb[k] = torch.from_numpy(v).to(torch.bfloat16 if bf16_floats else torch.float32)
        else:
            jb[k] = jnp.asarray(v, jnp.int32)
            tb[k] = torch.from_numpy(v)
    return jb, tb


def assert_logits(got, want, fp32, argmax=True, bf16_atol=BF16_LOGIT_ATOL):
    """fp32: within 1e-4 * max|want|; bf16: atol ``bf16_atol``, and
    (``argmax``) equal argmax. Decode steps in bf16 check no argmax, as
    ``test_torch_lm.py::test_decode_steps_match_jax`` does: random smoke
    weights leave near-ties within one bf16 ulp of the logits."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    if fp32:
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=bf16_atol)
        if argmax:
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def assert_trees_close(got, want, rel_to_max=None, **tol):
    """Every leaf of two cache trees (port tensors, JAX arrays) close, with
    equal shapes and dtypes: at ``tol``, or within ``rel_to_max`` * max|leaf|."""
    g_leaves = jax.tree_util.tree_leaves_with_path(got)
    w_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    for (path, g), (_, w) in zip(g_leaves, w_leaves):
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        g, w = to_np(g), to_np(w)
        if rel_to_max is None:
            np.testing.assert_allclose(g, w, err_msg=str(path), **tol)
        else:
            assert np.abs(g - w).max() <= rel_to_max * np.abs(w).max(), path


def jax_serve(jm, params, batch, gen_len):
    """``repro.launch.serve_lm.main``'s loop on a given batch: greedy ids
    (B, gen_len + 1)."""
    prefill, decode = jitted(jm)
    b = batch["tokens"].shape[0]
    p = (batch["frames"].shape[1] if "frames" in batch else
         batch["tokens"].shape[1] + (batch["patches"].shape[1] if "patches" in batch else 0))
    logits = prefill(params, batch)
    out = [jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)]
    cache = jm.make_cache(b, p + gen_len)
    for i in range(gen_len):
        logits, cache = decode(params, cache, out[-1], jnp.asarray(p + i, jnp.int32))
        out.append(jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32))
    return np.asarray(jnp.concatenate(out, axis=1))


def decode_steps(jm, params, tm, toks, cache_len, start=0):
    """Decode ``toks`` (B, n) one at a time from ``start`` on both sides;
    yields (step, JAX logits, port logits, JAX cache, port cache)."""
    _, decode = jitted(jm)
    b = toks.shape[0]
    cj, ct = jm.make_cache(b, cache_len), tm.make_cache(b, cache_len)
    for i in range(toks.shape[1]):
        lj, cj = decode(params, cj, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                        jnp.asarray(start + i, jnp.int32))
        lt, ct = tm.decode_step(ct, torch.from_numpy(toks[:, i:i + 1]), start + i)
        yield i, lj, lt, cj, ct


# ---------------------------------------------------------------------------
# training: loss and gradients (test_torch_train_*.py)
# ---------------------------------------------------------------------------

#: fp32 loss and xent rtol, aux rtol; each gradient leaf within GRAD_REL *
#: max|JAX leaf| (fp32 sums in another order; measured <= 3.7e-5, jamba's)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
#: bf16 loss against JAX run op by op
BF16_LOSS_ATOL = 0.02
_VG = {}


def train_batch(jm, b, s, seed, vocab=256):
    """A numpy train batch of ``jm``'s layout for sequence length ``s``:
    tokens and targets (decoder length for encdec, text length for vlm),
    with N(0, 1) frames or patches."""
    cfg = jm.cfg
    rng = np.random.default_rng(seed)
    out = {}
    n = s
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        n = jm.dec_len(s)
    elif cfg.family == "vlm":
        out["patches"] = rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
        n = s - cfg.n_patches
    out["tokens"] = rng.integers(0, vocab, (b, n))
    out["targets"] = rng.integers(0, vocab, (b, n))
    return out


def jax_value_and_grad(jm):
    """``value_and_grad(jm.loss, has_aux=True)``, jitted for fp32 models
    (once per model), op by op for bf16 ones."""
    if id(jm) not in _VG:
        fn = jax.value_and_grad(jm.loss, has_aux=True)
        _VG[id(jm)] = (jm, jax.jit(fn) if jm.cfg.compute_dtype == "float32" else fn)
    return _VG[id(jm)][1]


def grad_tree(params):
    """The JAX params as port tensors in the JAX layout, requiring grad."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a.astype(jnp.float32)))
                        .to(torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
                        .requires_grad_(True), params)


def port_loss_and_grads(tm, params, batch):
    """(loss, metrics, grads in jax.tree.leaves order) of the port's
    ``Model.loss`` on the JAX params."""
    tree = grad_tree(params)
    loss, metrics = tm.loss(batch, tree)
    loss.backward()
    return loss, metrics, [t.grad for t in jax.tree.leaves(tree)]


def assert_loss_close(tl, tmet, jl, jmet):
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(float(tmet[k].detach()), float(jmet[k]), rtol=LOSS_RTOL)


def assert_grads_close(tgrads, jgrads, rel=GRAD_REL):
    """Every leaf of equal shape and within ``rel`` * max|JAX leaf|."""
    paths = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(paths) == len(tgrads)
    for (path, w), g in zip(paths, tgrads):
        assert g is not None, path
        w = to_np(w)
        assert tuple(g.shape) == w.shape, path
        assert np.abs(to_np(g) - w).max() <= rel * np.abs(w).max(), path

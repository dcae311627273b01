"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``).

* The four checkpoint cases of ``tests/test_checkpoint_trainer.py``, ported:
  round trip, ``keep`` GC, shape mismatch, the asynchronous checkpointer.
* bf16, fp8 (e4m3fn and e5m2), int32 and bool leaves round-tripped bit for
  bit; an asynchronous save whose source tensor (or array) is overwritten
  right after ``save()`` still restores the old values; a missing leaf
  raises ``KeyError``; where restored leaves are placed.
* Across packages: a tree that JAX's ``save_checkpoint`` writes is read by
  the port's ``restore_checkpoint``, and the reverse, with a bf16 leaf and
  nested dicts: bit-equal leaves, and manifests identical apart from the
  order of the leaves.

No Newton step is compiled here.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)


def small_tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((4, 8), generator=gen),
        "nested": {"b": torch.arange(6, dtype=torch.int32),
                   "c": torch.tensor(3.5)},
    }


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bytes of a tensor, for bit-for-bit comparisons."""
    return t.detach().cpu().reshape(-1).view(torch.uint8).numpy()


def test_checkpoint_roundtrip(tmp_path):
    tree = small_tree()
    save_checkpoint(str(tmp_path), tree, step=7)
    assert latest_step(str(tmp_path)) == 7
    restored = restore_checkpoint(str(tmp_path), tree)
    torch.testing.assert_close(restored["a"], tree["a"], rtol=0, atol=0)
    torch.testing.assert_close(restored["nested"]["b"], tree["nested"]["b"], rtol=0, atol=0)
    assert float(restored["nested"]["c"]) == 3.5


def test_checkpoint_gc_keeps_last_k(tmp_path):
    tree = small_tree()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), tree, step=s, keep=2)
    steps = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step"))
    assert steps == ["step_00000004", "step_00000005"]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), small_tree(), step=1)
    bad = small_tree()
    bad["a"] = torch.zeros((2, 2))
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), bad)


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    tree = small_tree(1)
    ck.save(tree, step=3)
    ck.wait()
    assert latest_step(str(tmp_path)) == 3
    restored = restore_checkpoint(str(tmp_path), tree)
    torch.testing.assert_close(restored["a"], tree["a"], rtol=0, atol=0)


def test_missing_leaf_raises_key_error(tmp_path):
    save_checkpoint(str(tmp_path), small_tree(), step=1)
    with pytest.raises(KeyError, match="extra"):
        restore_checkpoint(str(tmp_path), dict(small_tree(), extra=torch.zeros(2)))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), small_tree())


@pytest.mark.parametrize("dtype,name", [
    (torch.bfloat16, "bfloat16"), (torch.float8_e4m3fn, "float8_e4m3fn"),
    (torch.float8_e5m2, "float8_e5m2"), (torch.int32, "int32"), (torch.bool, "bool")])
def test_leaf_dtypes_round_trip_bit_for_bit(tmp_path, dtype, name):
    gen = torch.Generator().manual_seed(5)
    if dtype == torch.bool:
        x = torch.rand((3, 7), generator=gen) > 0.5
    elif dtype == torch.int32:
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, (3, 7), generator=gen, dtype=torch.int32)
    else:
        x = (8 * torch.randn((3, 7), generator=gen)).to(dtype)
    save_checkpoint(str(tmp_path), {"x": x, "list": [x[0], (x[1],)]}, step=1)
    manifest = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
    assert [leaf["dtype"] for leaf in manifest["leaves"]] == [name] * 3
    assert [leaf["path"] for leaf in manifest["leaves"]] == ["list.0", "list.1.0", "x"]
    out = restore_checkpoint(str(tmp_path), {"x": x, "list": [x[0], (x[1],)]})
    assert out["x"].dtype == dtype and isinstance(out["list"][1], tuple)
    np.testing.assert_array_equal(_bits(out["x"]), _bits(x))
    np.testing.assert_array_equal(_bits(out["list"][1][0]), _bits(x[1]))


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_async_save_is_a_snapshot(tmp_path, kind):
    """The caller may write its buffer the moment ``save()`` returns (the
    server's donating step updates velocities in place): the checkpoint
    holds the values at the call."""
    v = torch.arange(4096, dtype=torch.float32)
    src = v if kind == "tensor" else v.numpy()   # .numpy() shares v's memory
    before = v.clone()
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save({"v": src}, step=1)
    v.fill_(-1.0)
    ck.wait()
    out = restore_checkpoint(str(tmp_path), {"v": torch.zeros(4096)})
    torch.testing.assert_close(out["v"], before, rtol=0, atol=0)


def test_restore_places_leaves(tmp_path):
    save_checkpoint(str(tmp_path), {"a": torch.ones(3), "b": np.zeros(2)}, step=1)
    out = restore_checkpoint(str(tmp_path), {"a": torch.zeros(3), "b": np.zeros(2)})
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in out.values())
    out = restore_checkpoint(str(tmp_path), {"a": np.zeros(3)}, device="cpu")
    assert out["a"].device.type == "cpu"


def test_restore_on_cuda_without_card_raises(tmp_path, monkeypatch):
    save_checkpoint(str(tmp_path), {"a": torch.ones(3)}, step=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros(3)}, device="cuda")


# ---------------------------------------------------------------------------
# Across packages: the disk format is the contract
# ---------------------------------------------------------------------------


def _jax_tree():
    k = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(k)
    return {
        "v": jax.random.normal(k1, (3, 4, 5, 6), jnp.float32),
        "meta": {"grid": jnp.asarray([4, 5, 6], jnp.int32),
                 "gnorm_ref": jnp.float32(7.25),
                 "inner": {"w16": jax.random.normal(k2, (5, 3)).astype(jnp.bfloat16)}},
        "mask": jnp.asarray([True, False, True]),
    }


def _torch_like(jtree):
    """The same tree as torch tensors (bf16 moved over bit for bit)."""
    def conv(x):
        a = np.asarray(x)
        if str(a.dtype) == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(conv, jtree)


def _manifest(path, step):
    m = json.loads((path / f"step_{step:08d}" / "manifest.json").read_text())
    return m["step"], sorted(m["leaves"], key=lambda leaf: leaf["path"])


def _flat_bits_jax(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jck.checkpoint._leaf_path(p): np.ascontiguousarray(x).tobytes()
            for p, x in leaves}


def _flat_bits_torch(tree, prefix=""):
    out = {}
    for k, x in tree.items():
        name = f"{prefix}{k}"
        if isinstance(x, dict):
            out.update(_flat_bits_torch(x, name + "."))
        else:
            out[name] = _bits(x).tobytes()
    return out


def test_jax_checkpoint_read_by_port(tmp_path):
    jtree = _jax_tree()
    jck.save_checkpoint(str(tmp_path / "jax"), jtree, step=4)
    target = _torch_like(jtree)
    out = restore_checkpoint(str(tmp_path / "jax"), jax.tree.map(torch.zeros_like, target))
    assert out["meta"]["inner"]["w16"].dtype == torch.bfloat16
    assert out["mask"].dtype == torch.bool
    assert _flat_bits_torch(out) == _flat_bits_jax(jtree)
    save_checkpoint(str(tmp_path / "port"), target, step=4)
    assert _manifest(tmp_path / "port", 4) == _manifest(tmp_path / "jax", 4)


def test_port_checkpoint_read_by_jax(tmp_path):
    jtree = _jax_tree()
    tree = _torch_like(jtree)
    save_checkpoint(str(tmp_path / "port"), tree, step=9, keep=2)
    out = jck.restore_checkpoint(str(tmp_path / "port"), jax.tree.map(jnp.zeros_like, jtree))
    assert out["meta"]["inner"]["w16"].dtype == jnp.bfloat16
    assert _flat_bits_jax(out) == _flat_bits_torch(tree)
    assert jck.latest_step(str(tmp_path / "port")) == 9
    jck.save_checkpoint(str(tmp_path / "jax"), jtree, step=9)
    assert _manifest(tmp_path / "jax", 9) == _manifest(tmp_path / "port", 9)


def test_namedtuple_train_state_round_trips_with_jax_paths(tmp_path):
    """A ``TrainState(params, opt)`` (a NamedTuple) saves under JAX's leaf
    paths (``.params.<...>``, ``.opt.<...>``), restores as a ``TrainState``
    bit for bit, and JAX's manifest of the same state is identical."""
    from repro.train.steps import TrainState as JTrainState
    from repro_torch.train.steps import TrainState

    jtree = _jax_tree()
    jstate = JTrainState({"w": jtree["v"], "inner": jtree["meta"]["inner"]},
                         {"m": [jtree["v"]], "step": jnp.asarray(5, jnp.int32)})
    state = TrainState(*(_torch_like(part) for part in jstate))
    save_checkpoint(str(tmp_path / "port"), state, step=5)
    out = restore_checkpoint(str(tmp_path / "port"), jax.tree.map(torch.zeros_like, state))
    assert isinstance(out, TrainState) and isinstance(out.opt["m"], list)
    assert _flat_bits_torch(out.params) == _flat_bits_torch(state.params)
    assert bytes(_bits(out.opt["m"][0])) == bytes(_bits(state.opt["m"][0]))
    assert int(out.opt["step"]) == 5 and out.opt["step"].dtype == torch.int32
    jck.save_checkpoint(str(tmp_path / "jax"), jstate, step=5)
    assert _manifest(tmp_path / "port", 5) == _manifest(tmp_path / "jax", 5)
    assert {leaf["path"] for leaf in _manifest(tmp_path / "port", 5)[1]} == {
        ".params.w", ".params.inner.w16", ".opt.m.0", ".opt.step"}

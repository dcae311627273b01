"""Port parity of the sharding rules (``repro_torch.distributed.sharding``)
and meshes (``repro_torch.launch.mesh``) against the JAX package's.

JAX's ``tests/test_sharding_rules.py`` does not collect under JAX 0.9
(``AbstractMesh``'s signature changed, ROADMAP C), but JAX's spec functions
read any object with ``axis_names`` and a ``shape`` dict: a stub mesh is
the oracle, with no devices and no compile. Every leaf's ``param_spec`` and
``opt_spec`` of every arch in ``ARCHS`` (full published configs: JAX's
``abstract_params``, the port's train state on ``meta``) equals JAX's, path
for path, on the meshes (16, 16), (2, 16, 16), (2, 2), (4, 1) and (1, 4);
so do ``batch_specs``, ``cache_specs``, ``logits_spec`` and the four
activation rules (JAX's hooks with the constraint replaced by a function
that returns its spec; JAX's residual at its default, split). The eight
intents of the red file are restated against the port, and the block
helpers (``local_shape``, ``shard``, ``gather``) are checked on a one-rank
gloo world and on coordinates.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as JARCHS
from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro.models import build_model as jbuild
from repro_torch.configs import ARCHS
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as ML
from repro_torch.models import build_model
from repro_torch.optim import adamw as TO
from repro_torch.train import steps as TS

torch.set_num_threads(1)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")), "4x1": ((4, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
MESH_1POD, MESH_2POD = ML.make_production_mesh(), ML.make_production_mesh(multi_pod=True)


def _stub(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def _is_p(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _jleaves(tree):
    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=_is_p)]


_PARAMS = {}


def params_of(arch):
    """(JAX abstract params, port params on meta) of the full config."""
    if arch not in _PARAMS:
        _PARAMS[arch] = (jbuild(JARCHS[arch]).abstract_params(),
                         TS.abstract_train_state(build_model(ARCHS[arch], "cpu")).params)
    return _PARAMS[arch]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_opt_specs_match_jax(arch, mesh):
    jp, tp = params_of(arch)
    stub = _stub(mesh)
    jpaths = [jshd._path_str(p) for p, _ in jax.tree_util.tree_leaves_with_path(jp)]
    tpaths = TO.leaves(shd._map_with_path(lambda path, _: path, tp))
    assert tpaths == jpaths
    assert [tuple(t.shape) for t in TO.leaves(tp)] == [a.shape for a in jax.tree.leaves(jp)]
    pm = ML.Mesh(*MESHES[mesh])
    for fn_t, fn_j in ((shd.param_specs, jshd.param_specs), (shd.opt_specs, jshd.opt_specs)):
        want = _jleaves(fn_j(jp, stub))
        for m in (stub, pm):  # a stub and the port's own abstract mesh
            got = TO.leaves(fn_t(tp, m))
            assert all(isinstance(s, shd.PartitionSpec) for s in got)
            assert [tuple(s) for s in got] == want


def _batch_shapes():
    return [(1, 524288), (2, 64), (4, 2048), (16, 128), (32, 4096), (256, 4096), (3, 7),
            (8, 2048, 576), (64, 1500, 1280)]


def _cache_shapes():
    return [(128, 32768, 4, 128), (8, 2048, 2, 64), (1, 100, 3, 64), (16, 24, 64, 128),
            (2, 4, 96), (32, 4, 3072), (4, 7, 5)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_cache_and_logits_specs_match_jax(mesh):
    stub = _stub(mesh)
    batch = {f"x{i}": jax.ShapeDtypeStruct(s, jnp.int32) for i, s in enumerate(_batch_shapes())}
    tbatch = {k: torch.empty(v.shape, device="meta") for k, v in batch.items()}
    got = shd.batch_specs(tbatch, stub)
    want = jshd.batch_specs(batch, stub)
    assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
    cache = {f"c{i}": jax.ShapeDtypeStruct(s, jnp.bfloat16)
             for i, s in enumerate(_cache_shapes())}
    tcache = {k: torch.empty(v.shape, device="meta") for k, v in cache.items()}
    got = shd.cache_specs(tcache, stub)
    want = jshd.cache_specs(cache, stub)
    assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
    for b in (1, 2, 16, 32, 256):
        for v in (256, 49152, 151936, 152064, 51866):
            assert tuple(shd.logits_spec(stub, b, v)) == tuple(jshd.logits_spec(stub, b, v))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_axis_helpers_match_jax(mesh):
    stub, pm = _stub(mesh), ML.Mesh(*MESHES[mesh])
    assert pm.axis_names == stub.axis_names and pm.shape == stub.shape
    assert ML.dp_axis_names(pm) == jmesh.dp_axis_names(stub)
    assert ML.model_axis_name(pm) == jmesh.model_axis_name(stub)
    for names in ("model", "data", "pod", ("pod", "data"), ("data", "model"), ()):
        assert ML.axis_size(pm, names) == jmesh.axis_size(stub, names)


#: activation shapes: (B, S) of the residual / q, the KV heads, the SSM
#: projection's width, the experts of a dispatched (E, G, C, D) tensor
_ACTIVATIONS = [(8, 2048, 2, 4096, 64), (4, 100, 3, 3354, 16), (32, 64, 16, 130, 6),
                (1, 16, 4, 64, 8)]


@pytest.mark.parametrize("mesh", MESHES)
def test_activation_rules_match_jax(mesh, monkeypatch):
    """The four activation rules give JAX's specs: JAX's constraint hooks
    run with ``with_sharding_constraint`` replaced by a function that
    returns the spec it was asked for, on the stub mesh."""
    stub = _stub(mesh)
    monkeypatch.setattr(jshd, "NamedSharding", lambda m, spec: spec)
    monkeypatch.setattr(jshd.jax.lax, "with_sharding_constraint", lambda x, spec: spec)
    monkeypatch.setattr(jshd, "RESIDUAL_SEQ_SHARD", True)
    for b, s, kvh, width, e in _ACTIVATIONS:
        x = types.SimpleNamespace(shape=(b, s, 64))
        assert tuple(shd.residual_constraint(stub)(x.shape)) == tuple(
            jshd.residual_constraint(stub)(x))
        q, k = (b, s, kvh, 3, 16), (b, s, kvh, 16)
        jq, jk, _ = jshd.qkv_constraint(stub)(*(types.SimpleNamespace(shape=t)
                                                for t in (q, k, k)))
        got = shd.qkv_constraint(stub)(q, k)
        assert (tuple(got[0]), tuple(got[1])) == (tuple(jq), tuple(jk))
        w = (b, s, width)
        assert tuple(shd.ssm_inner_constraint(stub)(w)) == tuple(
            jshd.ssm_inner_constraint(stub)(types.SimpleNamespace(shape=w)))
        d = (e, b, 8, 64)
        assert tuple(shd.expert_constraint(stub)(d)) == tuple(
            jshd.expert_constraint(stub)(types.SimpleNamespace(shape=d)))


@pytest.mark.parametrize("mesh", MESHES)
def test_residual_rule_with_the_residual_whole_matches_jax(mesh, monkeypatch):
    """``REPRO_RESIDUAL_SEQ=0`` in both packages: the residual stream is
    whole on every rank of a model group (batch over the data axes only)."""
    stub = _stub(mesh)
    monkeypatch.setattr(jshd, "NamedSharding", lambda m, spec: spec)
    monkeypatch.setattr(jshd.jax.lax, "with_sharding_constraint", lambda x, spec: spec)
    monkeypatch.setattr(jshd, "RESIDUAL_SEQ_SHARD", False)
    monkeypatch.setattr(shd, "RESIDUAL_SEQ_SHARD", False)
    for b, s, *_ in _ACTIVATIONS:
        got = tuple(shd.residual_constraint(stub)((b, s, 64)))
        assert got == tuple(jshd.residual_constraint(stub)(types.SimpleNamespace(
            shape=(b, s, 64))))
        assert got[1] is None


def test_production_meshes_are_abstract():
    assert MESH_1POD.shape == {"data": 16, "model": 16} and MESH_1POD.abstract
    assert MESH_2POD.shape == {"pod": 2, "data": 16, "model": 16} and MESH_2POD.size == 512
    assert not dist.is_initialized()
    m = ML.make_mesh((2, 2), ("data", "model"))
    assert m.abstract and m.size == 4
    with pytest.raises(ValueError, match="one distinct name per axis"):
        ML.Mesh((2, 2), ("data", "data"))


# ---------------------------------------------------------------------------
# The eight intents of tests/test_sharding_rules.py, against the port
# ---------------------------------------------------------------------------


def _check_divisible(specs, tree, mesh):
    flat_s, flat_l = TO.leaves(specs), TO.leaves(tree)
    assert len(flat_s) == len(flat_l)
    for spec, leaf in zip(flat_s, flat_l):
        for d, entry in enumerate(spec):
            div = int(np.prod([mesh.shape[a] for a in shd.entry_axes(entry)]))
            assert leaf.shape[d] % div == 0, (spec, leaf.shape)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mesh", [MESH_1POD, MESH_2POD], ids=["1pod", "2pod"])
def test_param_specs_always_divisible(arch, mesh):
    params = params_of(arch)[1]
    _check_divisible(shd.param_specs(params, mesh), params, mesh)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_specs_always_divisible(arch):
    params = params_of(arch)[1]
    _check_divisible(shd.opt_specs(params, MESH_2POD), params, MESH_2POD)


def test_embedding_vocab_sharded():
    specs = shd.param_specs(params_of("qwen2-7b")[1], MESH_1POD)
    assert specs["embed"]["table"][0] == "model"


def test_expert_dim_sharded():
    specs = shd.param_specs(params_of("olmoe-1b-7b")[1], MESH_1POD)
    seg = specs["decoder"]["seg0"]["sub0"]["mlp"]
    # (rep, E, D, F): expert dim over model
    assert seg["gate"][1] == "model"
    assert seg["down"][1] == "model"


def test_megatron_pairing_dense():
    specs = shd.param_specs(params_of("qwen2-7b")[1], MESH_1POD)
    sub = specs["decoder"]["seg0"]["sub0"]
    assert sub["mixer"]["wq"]["w"][-1] == "model"     # column
    assert sub["mixer"]["wo"]["w"][-2] == "model"     # row
    assert sub["mlp"]["gate"]["w"][-1] == "model"
    assert sub["mlp"]["down"]["w"][-2] == "model"


def test_opt_specs_add_dp_axis():
    params = params_of("jamba-v0.1-52b")[1]
    flat_p = TO.leaves(shd.param_specs(params, MESH_2POD))
    flat_o = TO.leaves(shd.opt_specs(params, MESH_2POD))
    improved = 0
    for ps, os_, leaf in zip(flat_p, flat_o, TO.leaves(params)):
        ents_p = [e for e in ps if e is not None]
        ents_o = [e for e in os_ if e is not None]
        assert len(ents_o) >= len(ents_p)
        if leaf.numel() > 1e6:
            improved += int(len(ents_o) > len(ents_p))
    assert improved > 10  # ZeRO-1 sharding actually engages on big leaves


def test_batch_specs_handle_tiny_batch():
    specs = shd.batch_specs({"tokens": torch.empty((1, 524288), device="meta")}, MESH_2POD)
    # batch of 1: unsharded batch dim; seq over model
    assert specs["tokens"][0] is None
    assert specs["tokens"][1] == "model"


def test_cache_specs_shard_seq_over_model():
    cache = {"k": torch.empty((128, 32768, 4, 128), device="meta", dtype=torch.bfloat16)}
    specs = shd.cache_specs(cache, MESH_1POD)
    assert specs["k"][0] == "data"
    assert specs["k"][1] == "model"


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [shd.P(), shd.P(None, "model"), shd.P(("pod", "data"), None),
                                  shd.P("data", ("pod", "model")), shd.P(None, None, "pod")],
                         ids=str)
def test_blocks_tile_the_full_tensor_major_to_minor(spec):
    """Every coordinate's block of ``shard`` has ``local_shape`` and sits
    where the row-major index of its entry's coordinates puts it."""
    mesh = ML.Mesh((2, 2, 3), ("pod", "data", "model"))
    full = torch.arange(12 * 12 * 4, dtype=torch.float32).reshape(12, 12, 4)
    cover = torch.zeros_like(full)
    for p in range(2):
        for d in range(2):
            for m in range(3):
                c = {"pod": p, "data": d, "model": m}
                mesh.coordinate = c.__getitem__  # this rank's place, without ranks
                blk = shd.shard(full, spec, mesh)
                assert tuple(blk.shape) == shd.local_shape(full.shape, spec, mesh)
                sl = []
                for dim in range(3):
                    axes = shd.entry_axes(spec[dim]) if dim < len(spec) else ()
                    idx, n = 0, 1
                    for a in axes:
                        idx, n = idx * mesh.shape[a] + c[a], n * mesh.shape[a]
                    size = full.shape[dim] // n
                    sl.append(slice(idx * size, (idx + 1) * size))
                assert torch.equal(blk, full[tuple(sl)])
                cover[tuple(sl)] = 1
    assert bool(cover.all())
    with pytest.raises(ValueError, match="does not split"):
        shd.local_shape((5, 4), shd.P("data"), mesh)


@pytest.mark.parametrize("spec", [shd.P(), shd.P(None, "model"), shd.P("data", None),
                                  shd.P(("pod", "data"), "model")], ids=str)
def test_shard_returns_the_input_when_no_dim_splits(spec):
    """On axes of size 1 a block is the whole tensor: ``shard`` hands back
    ``full`` itself (the one-device step copies no gradient), and
    ``gather`` of it runs no collective."""
    mesh = ML.Mesh((1, 1, 1), ("pod", "data", "model"))
    full = torch.arange(24.0).reshape(4, 6)
    assert shd.shard(full, spec, mesh) is full
    assert shd.gather(full, spec, mesh) is full
    split = ML.Mesh((1, 2, 1), ("pod", "data", "model"))
    split.coordinate = {"pod": 0, "data": 1, "model": 0}.__getitem__
    blk = shd.shard(full, spec, split)
    assert (blk is full) == all("data" not in shd.entry_axes(e) for e in spec)


def test_spec_pickles_and_prints():
    import pickle

    s = shd.P(("pod", "data"), None, "model")
    assert pickle.loads(pickle.dumps(s)) == s and isinstance(pickle.loads(pickle.dumps(s)),
                                                            shd.P)
    assert repr(s) == "P(('pod', 'data'), None, 'model')" and len(shd.P()) == 0


def test_make_mesh_on_a_world_checks_its_size_and_backend(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match=r"needs 4 ranks, the process group has 1"):
            ML.make_mesh((2, 2), ("data", "model"))
        with pytest.raises(RuntimeError, match="a cuda mesh runs on nccl"):
            ML.make_mesh((1, 1), ("data", "model"), device="cuda")
        mesh = ML.make_mesh((1, 1), ("data", "model"), device="cpu")
        assert not mesh.abstract and mesh.coordinate("data") == 0
        x = torch.arange(6.0).reshape(2, 3)
        spec = shd.P("data", "model")
        assert torch.equal(shd.gather(shd.shard(x, spec, mesh), spec, mesh), x)
        assert shd.mean_over([x], mesh, ["data", "model"])[0] is x
    finally:
        dist.destroy_process_group()

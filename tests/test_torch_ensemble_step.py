"""Port parity, the ensemble (population-study) Newton step:
``repro_torch.distributed.claire_dist.ensemble_newton_step`` against JAX's
vmapped ``ensemble_newton_step`` on two 8^3 pairs, one step with the
dry-run's budget (``GNConfig(max_pcg=6, ls_max=1)``), one jitted JAX step
for the module. The JAX step runs the ``fd8-linear`` variant: XLA compiles
the vmapped ``fd8-cubic`` step (64-tap plan gathers) in ~140 s on this
CPU, ``fd8-linear`` in ~4 s; the batching under test is the same.

Per pair, as ``test_torch_newton.py`` holds one pair's step: equal PCG
iterations and line-search evaluations; ``alpha``, the gradient norm and
``J`` within rtol 1e-5; the new velocity within 1e-5 * max|v|. Each pair's
stats and velocity are bit-equal to the port's own ``make_step`` on that
pair alone, for ``fd8-linear`` and ``fd8-cubic``. Also the shape errors,
and the layout helpers (specs, mesh axis names) against JAX's on stub
meshes.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gauss_newton as jGN
from repro.core.registration import make_transport_config as j_cfg
from repro.data import synthetic as jsyn
from repro.distributed import claire_dist as jCD
from repro_torch.core import gauss_newton as tGN
from repro_torch.core.registration import make_transport_config as t_cfg
from repro_torch.distributed import claire_dist as tCD
from repro_torch.launch import dryrun as tDR

torch.set_num_threads(1)

SHAPE, BATCH = (8, 8, 8), 2
BETA, GAMMA, ETA = 5e-4, 1e-4, 0.05
GN = dict(tDR.GN_CELL)
VARIANT = "fd8-linear"


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def jax_step():
    pairs = jsyn.make_batch(jax.random.PRNGKey(0), SHAPE, BATCH)
    v0 = jnp.zeros((BATCH, 3) + SHAPE, jnp.float32)
    step = jax.jit(jCD.ensemble_newton_step(j_cfg(VARIANT), jGN.GNConfig(**GN)))
    stats = step(pairs.m0, pairs.m1, v0, jnp.float32(BETA), jnp.float32(GAMMA),
                 jnp.float32(ETA))
    return dict(m0=np.asarray(pairs.m0), m1=np.asarray(pairs.m1),
                stats=jax.tree.map(np.asarray, stats))


@pytest.fixture(scope="module")
def port_step(jax_step):
    step = tCD.ensemble_newton_step(t_cfg(VARIANT), tGN.GNConfig(**GN))
    v0 = torch.zeros((BATCH, 3) + SHAPE)
    return step(_t(jax_step["m0"]), _t(jax_step["m1"]), v0, BETA, GAMMA, ETA)


@pytest.mark.parametrize("b", range(BATCH))
def test_ensemble_step_matches_jax_per_pair(jax_step, port_step, b):
    ref, got = jax_step["stats"], port_step
    assert int(ref.pcg_iters[b]) > 1
    assert int(got.pcg_iters[b]) == int(ref.pcg_iters[b])
    assert int(got.ls_evals[b]) == int(ref.ls_evals[b])
    for name in ("alpha", "gnorm", "j_total", "j_mismatch"):
        np.testing.assert_allclose(float(getattr(got, name)[b]), float(getattr(ref, name)[b]),
                                   rtol=1e-5, err_msg=name)
    v_new = ref.v_new[b]
    dv = float(np.max(np.abs(got.v_new[b].numpy() - v_new)))
    assert dv <= 1e-5 * float(np.max(np.abs(v_new))), dv


@pytest.mark.parametrize("variant", ["fd8-linear", "fd8-cubic"])
def test_ensemble_step_is_each_pairs_own_step(jax_step, variant):
    m0, m1 = _t(jax_step["m0"]), _t(jax_step["m1"])
    v = 0.05 * torch.randn((BATCH, 3) + SHAPE, generator=torch.Generator().manual_seed(3))
    gn = tGN.GNConfig(**GN)
    got = tCD.ensemble_newton_step(t_cfg(variant), gn)(m0, m1, v, BETA, GAMMA, ETA)
    for b in range(BATCH):
        one = tGN.make_step(t_cfg(variant), gn)(m0[b], m1[b], v[b], BETA, GAMMA, ETA)
        assert torch.equal(got.v_new[b], one.v_new)
        assert int(got.pcg_iters[b]) == one.pcg_iters
        assert int(got.ls_evals[b]) == one.ls_evals
        for name in tGN._SCALARS:
            assert torch.equal(getattr(got, name)[b], torch.as_tensor(getattr(one, name)))


def test_ensemble_step_shape_errors():
    step = tCD.ensemble_newton_step(t_cfg("fd8-cubic"), tGN.GNConfig(**GN))
    m = torch.zeros((BATCH,) + SHAPE)
    v = torch.zeros((BATCH, 3) + SHAPE)
    with pytest.raises(ValueError, match="batched images"):
        step(m[0], m[0], v[0], BETA, GAMMA, ETA)
    with pytest.raises(ValueError, match="batched images"):
        step(m, m[:1], v, BETA, GAMMA, ETA)
    with pytest.raises(ValueError, match="velocities"):
        step(m, m, v[:1], BETA, GAMMA, ETA)
    with pytest.raises(ValueError, match="velocities"):
        step(m, m, v[:, :2], BETA, GAMMA, ETA)


_MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
           "2x2": {"data": 2, "model": 2}, "slab": {"ensemble": 2, "slab": 4},
           "1": {"x": 1}}


def _stub(shape):
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


@pytest.mark.parametrize("mesh", sorted(_MESHES))
def test_layout_helpers_match_jax(mesh, monkeypatch):
    """JAX's helpers with ``NamedSharding`` returning its spec, on a stub
    mesh."""
    stub = _stub(_MESHES[mesh])
    monkeypatch.setattr(jCD, "NamedSharding", lambda m, spec: spec)
    for batch in (1, 2, 6, 16, 256, 512):
        got = tCD.ensemble_shardings(stub, batch)
        want = jCD.ensemble_shardings(stub, batch)
        assert [tuple(g) for g in got] == [tuple(w) for w in want]
    for grid in ((256, 256, 256), (24, 16, 16), (7, 8, 8)):
        got = tCD.slab_shardings(stub, grid)
        want = jCD.slab_shardings(stub, grid)
        assert [tuple(g) for g in got] == [tuple(w) for w in want]
    assert tCD.slab_axis_name(stub) == jCD.slab_axis_name(stub)
    assert tCD.ensemble_axis_name(stub) == jCD.ensemble_axis_name(stub)


def test_input_specs_match_jax():
    for got, want in ((tCD.ensemble_input_specs((8, 12, 16), 3),
                       jCD.ensemble_input_specs((8, 12, 16), 3)),
                      (tCD.slab_input_specs((8, 12, 16)), jCD.slab_input_specs((8, 12, 16)))):
        assert set(got) == set(want) == {"m0", "m1", "v"}
        for k in got:
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert got[k].dtype == torch.float32 and want[k].dtype == jnp.float32
    assert tCD.slab_newton_step is tCD.make_slab_step

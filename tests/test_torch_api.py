"""The port's registration facade (``repro_torch.api``), its CLI
(``repro_torch.launch.register``) and the gradient-descent baseline
(``core.baseline_gd``).

* ``SolverOptions`` validation and ``resolve_mode`` over the option matrix
  of ``tests/test_api_matrix.py`` (mode x batched x use_plan x mesh), with
  no solve; ``to_dict`` has JAX's keys with ``backend`` -> ``device`` and
  the mesh axis names (carried by the group layout) gone.
* ``Solver`` dispatch to single, multires and batch at 8^3 on the CPU, with
  the Dice fields, also on a one-rank gloo slab group and a 1 x 1 ensemble x
  slab layout; ``Result.to_dict`` and ``summary`` equal JAX's on the same
  fields.
* ``launch.register.main`` at ``--grid 8 --device cpu``; ``--device cuda``
  without a card raises.
* ``baseline_gd.solve`` against JAX's on the 8^3 pair of
  ``tests/test_measures.py`` (numpy), fd8-linear (JAX's fd8-cubic step
  takes ~50 s to compile here), 5 iterations: the same accepted steps and
  step sizes, gradient norms and objectives within 1e-4 relative and ``v``
  within 1e-4 * max|v| (fp32 noise through the transport solves).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import api as japi
from repro.core import baseline_gd as jBGD
from repro.core import registration as jR
from repro.data import synthetic as jsyn
from repro_torch import api
from repro_torch.core import baseline_gd as tBGD
from repro_torch.core import registration as tR
from repro_torch.distributed import group as tGR
from repro_torch.launch import register as launch_register

GRID = (8, 8, 8)
LEVELS = [(4, 4, 4), (8, 8, 8)]
ONE_BY_ONE = tGR.EnsembleSlabGroups(ensemble=None, slab=None, ensemble_size=1,
                                    slab_size=1)


def _options(mode, use_plan, mesh=None, **kw):
    return api.SolverOptions(variant="fd8-linear", nt=2, max_newton=2, mode=mode,
                             levels=LEVELS if mode == "multires" else None,
                             use_plan=use_plan, mesh=mesh, halo=4, device="cpu", **kw)


@pytest.mark.parametrize("use_plan", [True, False])
@pytest.mark.parametrize("meshed", [False, True])
@pytest.mark.parametrize("mode,batched", [("single", False), ("multires", False),
                                          ("batch", True)])
def test_option_matrix_resolves_without_solving(mode, batched, use_plan, meshed):
    o = _options(mode, use_plan, ONE_BY_ONE if meshed else None)
    assert o.resolve_mode(batched, GRID) == mode
    d = json.loads(json.dumps(o.to_dict()))
    assert d["mode"] == mode and d["use_plan"] == use_plan and d["device"] == "cpu"
    assert d["mesh"] == ({"ensemble": 1, "slab": 1} if meshed else None)
    if mode == "multires":
        assert d["levels"] == [list(s) for s in LEVELS]
    other = "single" if batched else "batch"
    with pytest.raises(ValueError, match="batch"):
        dataclasses.replace(o, mode=other).resolve_mode(batched, GRID)


def test_auto_mode_and_validation():
    o = api.SolverOptions(device="cpu")
    assert o.resolve_mode(True, GRID) == "batch"
    assert o.resolve_mode(False, (16, 16, 16)) == "multires"
    assert o.resolve_mode(False, GRID) == "single"
    assert api.SolverOptions().device == "cuda"
    for kw, msg in ((dict(mode="fast"), "mode must be"), (dict(variant="fd4"), "variant"),
                    (dict(coarse_variant="fd4"), "coarse_variant"),
                    (dict(measure="mi"), "unknown distance measure"),
                    (dict(device="meta"), "device must be"),
                    (dict(halo_compression="fp8"), "halo_compression"),
                    (dict(use_plan=False, use_fused_matvec=True), "use_fused_matvec")):
        with pytest.raises(ValueError, match=msg):
            api.SolverOptions(**kw)
    d = api.SolverOptions(measure=tR._meas.NGF(eps=0.05), gnorm_ref=2.0,
                          v0=torch.zeros((3,) + GRID)).to_dict()
    assert d["measure"] == "ngf" and d["gnorm_ref"] == 2.0 and d["v0"] == [3, 8, 8, 8]


def test_options_to_dict_has_jax_keys():
    ours = set(api.SolverOptions(device="cpu").to_dict())
    theirs = set(japi.SolverOptions().to_dict())
    assert ours == (theirs - {"backend", "slab_axis", "ensemble_axis"}) | {"device"}
    assert api.MODES == japi.MODES
    assert sorted(api.__all__) == sorted(japi.__all__)


def test_problem_validation():
    m = np.zeros(GRID, np.float32)
    with pytest.raises(ValueError, match="shapes differ"):
        api.RegistrationProblem(m0=m, m1=m[:4])
    with pytest.raises(ValueError, match="expected"):
        api.RegistrationProblem(m0=m[0], m1=m[0])
    with pytest.raises(ValueError, match="labels0"):
        api.RegistrationProblem(m0=m, m1=m, labels0=m[:4])
    p = api.RegistrationProblem.synthetic(seed=1, grid=GRID, batch=2, device="cpu")
    assert p.is_batched and p.batch_size == 2 and p.grid == GRID
    assert p.name == "synthetic-1-8x8x8-b2"


def _assert_populated(result, mode, batched):
    assert result.mode == mode and result.grid == GRID
    if batched:
        assert result.v.shape == (2, 3) + GRID and result.batch == 2
        assert len(result.dice_before) == len(result.dice_after) == 2
        assert all(np.isfinite(m) for m in result.mismatch_rel)
        assert all(m >= 1 for m in result.matvecs)
    else:
        assert result.v.shape == (3,) + GRID
        assert set(result.detF) == {"min", "mean", "max"}
        assert result.iters >= 1 and result.matvecs >= 1
        assert 0.0 <= result.dice_after <= 1.0 and 0.0 <= result.dice_before <= 1.0
    if mode == "multires":
        assert [tuple(s) for s in result.levels] == LEVELS
        assert result.fine_iters is not None and len(result.level_results) == 2
    json.dumps(result.to_dict())


@pytest.mark.parametrize("use_plan", [True, False])
@pytest.mark.parametrize("mode,batched", [("single", False), ("multires", False),
                                          ("batch", True)])
def test_solver_dispatch(mode, batched, use_plan):
    problem = api.RegistrationProblem.synthetic(seed=1 if batched else 0, grid=GRID,
                                                batch=2 if batched else None, device="cpu")
    result = api.Solver(_options(mode, use_plan)).solve(problem)
    _assert_populated(result, mode, batched)
    assert result.mesh is None
    if mode == "single":
        ref = tR.register(problem.m0, problem.m1, variant="fd8-linear", nt=2, max_newton=2,
                          use_plan=use_plan, device="cpu")
        assert result.iters == ref.iters and torch.equal(result.v, ref.v)


def test_solver_on_slab_groups(tmp_path):
    """The mesh leg: a one-rank gloo slab group (single) and a 1 x 1
    ensemble x slab layout (batch), through ``register_sharded``."""
    tGR.init_slab_group(0, 1, f"file://{tmp_path}/store", "cpu")
    try:
        single = api.RegistrationProblem.synthetic(seed=0, grid=GRID, device="cpu")
        res = api.solve(single, _options("single", True, dist.group.WORLD))
        _assert_populated(res, "single", False)
        assert res.mesh == {"slab": 1}
        ref = tR.register(single.m0, single.m1, variant="fd8-linear", nt=2, max_newton=2,
                          device="cpu")
        assert res.iters == ref.iters
        batch = api.RegistrationProblem.synthetic(seed=1, grid=GRID, batch=2, device="cpu")
        res = api.solve(batch, _options("batch", True, tGR.ensemble_slab_groups(1, 1)))
        _assert_populated(res, "batch", True)
        assert res.mesh == {"ensemble": 1, "slab": 1}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["single", "multires", "batch"])
def test_result_to_dict_and_summary_match_jax(mode):
    fields = dict(mode=mode, grid=GRID, v=None, m_warped=None, wall_time_s=1.5,
                  mismatch_rel=[0.1, 0.2] if mode == "batch" else 0.1,
                  detF={"min": 0.5, "mean": 1.0, "max": 2.0}, iters=3, matvecs=7,
                  rel_grad=0.04, converged=True, dice_before=0.6, dice_after=0.9,
                  mesh={"ensemble": 1, "slab": 1})
    if mode == "batch":
        fields["batch"] = 2
    if mode == "multires":
        fields.update(levels=LEVELS, fine_iters=2, level_results=[])
    ours, theirs = api.Result(**fields), japi.Result(**fields)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.summary() == theirs.summary()


def test_register_cli_on_cpu(capsys, monkeypatch):
    assert launch_register.main(["--grid", "8", "--device", "cpu", "--nt", "2",
                                 "--max-newton", "2", "--variant", "fd8-linear"]) == 0
    out = capsys.readouterr().out
    assert "grid=(8, 8, 8)" in out and "iters=2" in out and "det F: min=" in out
    with pytest.raises(SystemExit):
        launch_register.main(["--grid", "8", "--backend", "jnp"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_register.main(["--grid", "8"])


@pytest.fixture(scope="module")
def gd_pair():
    p = jsyn.make_pair(jax.random.PRNGKey(2), GRID, amplitude=0.4, nt=2)
    return np.array(p.m0), np.array(p.m1)


@pytest.mark.parametrize("variant", ["fd8-linear"])
def test_baseline_gd_matches_jax(gd_pair, variant):
    m0, m1 = gd_pair
    ref = jBGD.solve(m0, m1, jR.make_transport_config(variant), max_iters=5)
    got = tBGD.solve(torch.from_numpy(m0), torch.from_numpy(m1),
                     tR.make_transport_config(variant), max_iters=5)
    assert got.iters == ref.iters and len(got.history) == len(ref.history)
    assert [h["iter"] for h in got.history] == [h["iter"] for h in ref.history]
    assert [h["eta"] for h in got.history] == [h["eta"] for h in ref.history]
    np.testing.assert_allclose([h["gnorm"] for h in got.history],
                               [h["gnorm"] for h in ref.history], rtol=1e-4)
    np.testing.assert_allclose([h["j"] for h in got.history],
                               [h["j"] for h in ref.history], rtol=1e-4)
    dv = float(np.max(np.abs(got.v.numpy() - np.asarray(ref.v))))
    assert dv <= 1e-4 * float(np.max(np.abs(np.asarray(ref.v)))), dv

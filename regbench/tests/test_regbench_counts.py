"""The frozen work counts against what the program's route does at 16^3
on the CPU, and the shares they give."""

import json
import math
from pathlib import Path

import pytest
import torch

from regbench import counts, run as R, trace, window as W
from regbench.generator import pool, load

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
NAMES = ["claire-256-fp32-fused", "claire-256-bf16-planfree"]


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def pair():
    return pool(load("solve-closed-1"), (16, 16, 16), 4, seed=11, dev="cpu")[0]


def _spy(monkeypatch, module, name, tally, key, fields_of):
    orig = getattr(module, name)

    def spy(*a, **kw):
        tally[key] += fields_of(*a, **kw)
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, spy)


def _lead(t):
    return math.prod(t.shape[:-3])


@pytest.mark.parametrize("name", NAMES)
def test_counts_are_at_most_what_the_route_does(name, pair, monkeypatch):
    from repro_torch.core import registration
    from repro_torch.kernels import counts as launches, fd8, interp3d, prefilter

    tally = dict(interp=0, prefilter=0, fd8=0)
    for fn in ("apply_plan", "interp3d"):
        _spy(monkeypatch, interp3d, fn, tally, "interp", lambda c, *a, **k: _lead(c))
    _spy(monkeypatch, interp3d, "apply_plan_fused", tally, "interp", lambda c, *a, **k: 2)
    # one prefilter of a stack is three axis passes over its fields
    _spy(monkeypatch, prefilter, "stencil_axis", tally, "prefilter",
         lambda f, *a, **k: _lead(f) / 3)
    _spy(monkeypatch, fd8, "stencil_axis", tally, "fd8", lambda f, *a, **k: _lead(f))

    solver = _config(name)["solver"]
    launches.reset()
    res = registration.register(pair.m0, pair.m1, device="cpu", **W.solver_kwargs(solver))
    snap = launches.snapshot()
    work = counts.registration((16, 16, 16), solver["nt"], len(res.history), res.matvecs,
                               sum(h["ls_evals"] for h in res.history))
    n = 16 ** 3
    interp_launches = sum(v for k, v in snap.items()
                          if "apply_plan" in k or "interp3d" in k)
    assert work["interp"].passes <= interp_launches
    assert work["interp"].fields <= tally["interp"]
    assert work["prefilter"].fields <= tally["prefilter"]
    assert work["fd8"].flops / (13 * n) <= tally["fd8"]


class _Trace(trace.Trace):
    def __init__(self, seconds_by_name, window_s):
        ops, t = [], 0.0
        for name, s in seconds_by_name.items():
            ops.append((name, t, t + s))
            t += s
        super().__init__(ops, [], window_s)


@pytest.mark.parametrize("name", NAMES)
def test_a_solve_at_its_bound_reads_100_percent(name):
    cfg = _config(name)
    run = W.Run("claire256-fp32.solve", cfg, cfg["grid"], "cuda", 0.0)
    run.solves = [dict(evals=5, matvecs=25, ls=6), dict(evals=4, matvecs=17, ls=4)]
    work = counts.Work()
    by_kind = {k: counts.Work() for k in counts.KINDS}
    for s in run.solves:
        w = counts.registration(cfg["grid"], cfg["solver"]["nt"], s["evals"], s["matvecs"], s["ls"])
        for k in counts.KINDS:
            by_kind[k] = by_kind[k] + w[k]
        work = work + counts.total(w)
    stencil = by_kind["fd8"] + by_kind["prefilter"]
    run.trace = _Trace({"void (anonymous namespace)::interp3d_kernel<1, float>(...)":
                        by_kind["interp"].bound_s(),
                        "void stencil_strided_kernel<4, false>(...)": stencil.bound_s() / 2,
                        "void stencil_rows_kernel<true, true>(...)": stencil.bound_s() / 2},
                       window_s=work.bound_s())
    read = {m: R._load_reader(m)(run) for m in ("interp_roofline", "stencil_roofline",
                                                "solve_mfu")}
    assert read == pytest.approx({m: 100.0 for m in read}, rel=1e-12)


def test_a_kind_whose_kernels_are_absent_reads_nothing():
    cfg = _config(NAMES[0])
    run = W.Run("claire256-fp32.solve", cfg, cfg["grid"], "cuda", 0.0)
    run.solves = [dict(evals=5, matvecs=25, ls=6)]
    run.trace = _Trace({"void stencil_strided_kernel<4, false>(...)": 1.0}, window_s=2.0)
    assert R._load_reader("stencil_roofline")(run) is None
    assert R._load_reader("interp_roofline")(run) is None
    run.trace = _Trace({"void stencil_strided_kernel<4, false>(...)": 1.0,
                        "void stencil_rows_kernel<true, true>(...)": 1.0}, window_s=2.0)
    w = counts.registration(cfg["grid"], 4, 5, 25, 6)
    assert R._load_reader("stencil_roofline")(run) == pytest.approx(
        100.0 * (w["fd8"] + w["prefilter"]).bound_s() / 2.0)


def test_glue_counts_what_its_own_list_of_layers_leaves(tmp_path, monkeypatch):
    cfg = _config(NAMES[0])
    run = W.Run("claire256-fp32.solve", cfg, cfg["grid"], "cuda", 0.0)
    run.solves = [dict(evals=5, matvecs=25, ls=6), dict(evals=5, matvecs=25, ls=6)]
    run.trace = _Trace({"void interp3d_kernel<1, float>(...)": 0.3,
                        "void stencil_rows_kernel<true, true>(...)": 0.1,
                        "void vectorized_elementwise_kernel<4, AddFunctor>(...)": 0.5,
                        "void fused_rk2_kernel<float>(...)": 0.2}, window_s=2.0)
    glue = R._load_reader("glue_ms_per_solve")
    assert glue(run) == pytest.approx(1e3 * 0.7 / 2)
    # a layer added later, in a folder of its own, leaves glue as it was
    for name in ("interp", "fd8", "prefilter", "fft"):
        (tmp_path / name).symlink_to(trace.LAYERS / name)
    (tmp_path / "rk2").mkdir()
    (tmp_path / "rk2" / "k7.json").write_text(json.dumps(
        {"layer": "kernels: RK2", "kernels": ["fused_rk2_kernel"]}))
    monkeypatch.setattr(trace, "LAYERS", tmp_path)
    run.layers = trace.layers()
    assert set(run.layers) == {"interp", "fd8", "prefilter", "fft", "rk2"}
    assert glue(run) == pytest.approx(1e3 * 0.7 / 2)

"""The PyTorch port's boundaries: no JAX inside it, no quiet fallback from the
card to the CPU, explicit errors for what is not ported, and the synthetic
data and launch counts it relies on."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import interp as I
from repro_torch.core import measures as M
from repro_torch.core import registration as R
from repro_torch.core import semilag as SL
from repro_torch.data import synthetic as S
from repro_torch.kernels import counts
from repro_torch.kernels import interp3d as K
from repro_torch.kernels import pencil as P

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _bad_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.name}:{node.lineno} imports {name}")
    return bad


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    assert not _bad_imports(path)


def test_import_scan_catches_jax(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import jax.numpy as jnp\nfrom repro.core import grid\n"
                 "from repro_torch.core import grid as ok\n")
    assert len(_bad_imports(p)) == 2


def test_cuda_requested_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.register(m, m)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.make_pair(0, (8, 8, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.tensor_from_numpy(m)


def test_wrappers_refuse_other_devices():
    f = torch.zeros((8, 8, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        P.stencil_axis(f, 0, (1.0,), symmetric=True)
    q = torch.zeros((3, 8, 8, 8))
    plan = I.build_plan(q, "cubic_bspline")
    with pytest.raises(ValueError, match="cpu or cuda"):
        K.apply_plan(f, plan)


def test_unported_paths_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="A11"):
        R.make_transport_config(mixed_precision=True)
    with pytest.raises(NotImplementedError, match="B4"):
        R.make_transport_config(use_plan=False)
    for name in ("ncc", "ngf"):
        with pytest.raises(NotImplementedError, match="A12"):
            M.resolve(name)
    with pytest.raises(NotImplementedError, match="A18"):
        R.register_sharded(None, None, mesh=None)
    f = torch.zeros((8, 8, 8))
    with pytest.raises(NotImplementedError, match="B4"):
        SL.sl_step(f, torch.zeros((3, 8, 8, 8)))
    with pytest.raises(ValueError, match="unknown"):
        M.resolve("mutual-information")
    with pytest.raises(ValueError, match="use_fused_matvec requires"):
        R.make_transport_config(use_plan=False, use_fused_matvec=True)


def test_cpu_wrappers_take_plain_versions_and_count_them():
    counts.reset()
    f = torch.randn((2, 8, 8, 8), generator=torch.Generator().manual_seed(0))
    out = P.stencil_axis(f, 1, (0.5, 0.25), symmetric=False, scale=2.0)
    torch.testing.assert_close(out, P.stencil_axis_plain(f, 1, (0.5, 0.25), False, 2.0),
                               rtol=0, atol=0)
    q = torch.rand((3, 8, 8, 8), generator=torch.Generator().manual_seed(1)) * 8
    plan = I.build_plan(q, "cubic_bspline")
    K.apply_plan(f, plan)
    K.apply_plan_fused(f, plan, f[0], "inc_adjoint", 0.25)
    snap = counts.snapshot()
    assert snap == {"plain:stencil_axis:fd8": 1, "plain:apply_plan": 1,
                    "plain:apply_plan_fused:inc_adjoint": 1}
    counts.reset()
    assert counts.snapshot() == {}


def test_make_pair_is_deterministic_and_well_formed():
    a = S.make_pair(3, (12, 12, 12), amplitude=0.5, device="cpu")
    b = S.make_pair(3, (12, 12, 12), amplitude=0.5, device="cpu")
    c = S.make_pair(4, (12, 12, 12), amplitude=0.5, device="cpu")
    for x, y in ((a.m0, b.m0), (a.m1, b.m1), (a.v_true, b.v_true)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a.m0, c.m0)
    assert a.m0.shape == (12, 12, 12) and a.v_true.shape == (3, 12, 12, 12)
    assert float(a.m0.min()) >= 0.0 and abs(float(a.m0.max()) - 1.0) < 1e-6
    vmag = torch.sqrt(torch.sum(a.v_true ** 2, dim=0))
    assert abs(float(vmag.max()) - 0.5) < 1e-6
    assert torch.isfinite(a.m1).all()
    assert set(torch.unique(a.labels1).tolist()) <= {0.0, 1.0}


def test_interop_plan_and_gradient_state_roundtrip():
    rng = np.random.default_rng(0)
    idx = [rng.integers(0, 64, (4, 4, 4, 4)).astype(np.int64) for _ in range(3)]
    w = [rng.standard_normal((4, 4, 4, 4)).astype(np.float32) for _ in range(3)]
    plan = interop.plan_from_numpy(idx, w, "cubic_bspline", (4, 4, 4), device="cpu")
    assert all(t.dtype == torch.int32 for t in plan.idx)
    assert plan.out_shape == (4, 4, 4) and plan.support == 4
    arr = rng.standard_normal((4, 4, 4)).astype(np.float32)
    state = dict(g=arr, m_traj=arr, lam_traj=arr, foot_fwd=arr, foot_adj=arr,
                 divv=arr, j_mismatch=np.float32(1.5), j_reg=np.float32(0.5),
                 plan_fwd=dict(idx=idx, weights=w, method="cubic_bspline",
                               field_shape=(4, 4, 4)),
                 plan_adj=plan, grad_m_traj=None, measure_cache=None)
    gs = interop.gradient_state_from_numpy(state, device="cpu")
    assert float(gs.j_mismatch) == 1.5 and gs.grad_m_traj is None
    assert torch.equal(gs.plan_fwd.idx[2], plan.idx[2])
    with pytest.raises(NotImplementedError, match="A12"):
        interop.gradient_state_from_numpy(dict(state, measure_cache=(1,)), "cpu")


def test_chip_smoke_without_card_or_repo_fails(tmp_path, monkeypatch):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    # Alone in a directory, the script cannot reach the port and fails.
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(lone), "--size", "8"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout

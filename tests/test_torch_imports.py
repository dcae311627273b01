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
import torch.distributed as dist

from repro_torch import api, interop
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import interp as I
from repro_torch.core import measures as M
from repro_torch.core import registration as R
from repro_torch.core import semilag as SL
from repro_torch.data import synthetic as S
from repro_torch.distributed import group as G
from repro_torch.kernels import counts
from repro_torch.kernels import flashattn as FA
from repro_torch.kernels import interp3d as K
from repro_torch.kernels import pencil as P
from repro_torch.launch import serve_lm
from repro_torch.models import build_model

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "examples_torch").glob("*.py")) + [ROOT / "chip_smoke.py"])


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
            if top in ("jax", "jaxlib", "ml_dtypes", "repro"):
                bad.append(f"{path.name}:{node.lineno} imports {name}")
    return bad


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    assert not _bad_imports(path)


def test_import_scan_covers_the_slab_package():
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for name in ("__init__", "claire_dist", "compression", "group", "halo", "sharding", "tp"):
        assert f"src/repro_torch/distributed/{name}.py" in scanned


def test_import_scan_covers_the_lm_path():
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for name in ("configs/base", "configs/registry", "configs/qwen1_5_0_5b",
                 "configs/smollm_135m", "models/layers", "models/attention",
                 "models/transformer", "models/api", "models/moe", "models/ssm",
                 "launch/serve_lm", "kernels/flashattn"):
        assert f"src/repro_torch/{name}.py" in scanned
    assert (ROOT / "src/repro_torch/csrc/flashattn.cu").exists()


def test_import_scan_covers_the_facade_batch_and_measures():
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for name in ("api/__init__", "api/options", "api/problem", "api/result", "api/solver",
                 "launch/register", "core/baseline_gd", "core/measures",
                 "core/gauss_newton", "core/registration", "distributed/claire_dist",
                 "distributed/group", "data/synthetic", "interop"):
        assert f"src/repro_torch/{name}.py" in scanned


def test_import_scan_covers_training():
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for name in ("data/tokens", "optim/__init__", "optim/adamw", "train/__init__",
                 "train/steps", "train/trainer", "launch/train"):
        assert f"src/repro_torch/{name}.py" in scanned


def test_import_scan_covers_sharded_training_and_the_roofline():
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for name in ("launch/mesh", "distributed/sharding", "distributed/compression",
                 "roofline/__init__", "roofline/analysis", "roofline/lm"):
        assert f"src/repro_torch/{name}.py" in scanned


def test_import_scan_covers_the_dryrun_and_the_examples():
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for name in ("launch/dryrun", "roofline/counts", "roofline/debug", "kernels/counts",
                 "distributed/claire_dist"):
        assert f"src/repro_torch/{name}.py" in scanned
    for name in ("quickstart", "registration_3d", "multires_registration",
                 "multimodal_registration", "ensemble_registration", "serve_registration",
                 "serve_lm", "train_lm"):
        assert f"examples_torch/{name}.py" in scanned
        assert (ROOT / "examples" / f"{name}.py").exists()


def test_import_scan_covers_checkpoint_and_serve():
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for name in ("checkpoint/__init__", "checkpoint/checkpoint", "serve/__init__",
                 "serve/request", "serve/batching", "serve/cache", "serve/metrics",
                 "serve/server", "launch/serve_registration", "launch/serve"):
        assert f"src/repro_torch/{name}.py" in scanned


def test_import_scan_covers_the_kernel_wrappers():
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for name in ("_build", "counts", "fd8", "interp3d", "pencil", "plan", "prefilter",
                 "contract"):
        assert f"src/repro_torch/kernels/{name}.py" in scanned
    for name in ("interp3d", "pencil", "plan", "contract"):
        assert (ROOT / "src/repro_torch/csrc" / f"{name}.cu").exists()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-780m", "jamba-v0.1-52b",
                                  "whisper-large-v3", "internvl2-1b"])
def test_unported_lm_families_raise_not_implemented(arch):
    """Every family takes train cells: the prefill batch plus ``targets`` of
    the tokens' shape (the decoder's for encdec, the text's for vlm); a cell
    of another kind raises."""
    cfg = ARCHS[arch].smoke()
    assert cfg.family in ("moe", "ssm", "hybrid", "encdec", "vlm")
    model = build_model(cfg, device="cpu")
    pre = model.input_specs(ShapeConfig("p", 32, 2, "prefill"))["batch"]
    train = model.input_specs(ShapeConfig("t", 32, 2, "train"))["batch"]
    assert set(train) == set(pre) | {"targets"}
    assert train["targets"] == train["tokens"] == pre["tokens"]
    assert train["targets"].shape == (2, model.dec_len(32) if cfg.is_encdec
                                      else model.text_len(32))
    with pytest.raises(ValueError, match="cell kind"):
        model.input_specs(ShapeConfig("x", 32, 2, "serve"))


def test_serve_lm_on_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--arch", "smollm-135m", "--smoke", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(ARCHS["qwen1.5-0.5b"].smoke())


def test_cpu_flash_attention_takes_plain_version_and_counts_it():
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((3, 40, 16), generator=gen) for _ in range(3))
    counts.reset()
    for causal in (False, True):
        torch.testing.assert_close(FA.flash_attention(q, k, v, causal),
                                   FA.flash_attention_plain(q, k, v, causal), rtol=0, atol=0)
    assert counts.snapshot() == {"plain:flash_attention": 2}
    counts.reset()


def test_cuda_slab_group_without_nccl_raises(monkeypatch, tmp_path):
    """No quiet gloo in place of NCCL, and no group on another device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs NCCL"):
        G.init_slab_group(0, 1, f"file://{tmp_path}/store", "cuda")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        G.init_slab_group(0, 1, f"file://{tmp_path}/store", "meta")
    assert not dist.is_initialized()


def test_import_scan_catches_jax(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import jax.numpy as jnp\nfrom repro.core import grid\n"
                 "import ml_dtypes\nfrom repro_torch.core import grid as ok\n")
    assert len(_bad_imports(p)) == 3


def test_cuda_requested_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.register(m, m)
    for kw in (dict(use_plan=False), dict(mixed_precision=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            R.register(m, m, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.register_multires(m, m)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.make_pair(0, (8, 8, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.tensor_from_numpy(m)
    m4 = np.zeros((2, 8, 8, 8), np.float32)
    for call in (lambda: R.register_batch(m4, m4), lambda: R.register(m, m, measure="ncc"),
                 lambda: S.make_batch(0, (8, 8, 8), 2),
                 lambda: S.make_multimodal_pair(0, (8, 8, 8)),
                 lambda: api.solve(api.RegistrationProblem(m0=m, m1=m)),
                 lambda: api.RegistrationProblem.synthetic(grid=(8, 8, 8))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_wrappers_refuse_other_devices():
    f = torch.zeros((8, 8, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        P.stencil_axis(f, 0, (1.0,), symmetric=True)
    q = torch.zeros((3, 8, 8, 8))
    plan = I.build_plan(q, "cubic_bspline")
    with pytest.raises(ValueError, match="cpu or cuda"):
        K.apply_plan(f, plan)
    with pytest.raises(ValueError, match="cpu or cuda"):
        K.interp3d(f, q, "cubic_lagrange")


def test_unported_paths_raise_not_implemented():
    # bf16 weights (A11), the plan-free path (B4), NCC/NGF (A12) and the
    # ensemble x slab mode (A14) are ported: they build configs and resolve
    # instead of raising.
    cfg = R.make_transport_config(mixed_precision=True, use_plan=False)
    assert cfg.weight_dtype == torch.bfloat16 and not cfg.use_plan
    assert R.make_transport_config().weight_dtype is None
    for name in ("ncc", "ngf"):
        assert M.resolve(name).name == name
        assert R.make_transport_config(measure=name).measure == name
    # The slab solve and its ensemble x slab mode run on an initialised
    # group; without one they raise.
    m4 = np.zeros((2, 8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="initialised torch.distributed group"):
        R.register_sharded(m4, m4, device="cpu")
    with pytest.raises(RuntimeError, match="initialised torch.distributed group"):
        R.register_sharded(m4[0], m4[0], device="cpu")
    f = torch.zeros((8, 8, 8))
    q = torch.zeros((3, 8, 8, 8))
    assert torch.equal(SL.sl_step(f, q), f)
    assert torch.equal(SL.sl_step(f, q, weight_dtype=torch.bfloat16), f)
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
    K.interp3d(f, q, "linear")
    snap = counts.snapshot()
    assert snap == {"plain:stencil_axis:fd8": 1, "plain:build_plan:cubic_bspline": 1,
                    "plain:apply_plan": 1, "plain:apply_plan_fused:inc_adjoint": 1,
                    "plain:interp3d:linear": 1}
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
    with pytest.raises(ValueError, match="measure cache"):
        interop.gradient_state_from_numpy(dict(state, measure_cache=(1,)), "cpu")
    ncc = dict(g=arr, a=np.float32(0.5), b=np.float32(2.0), c=np.float32(3.0))
    gs = interop.gradient_state_from_numpy(dict(state, measure_cache=ncc), "cpu")
    assert isinstance(gs.measure_cache, M._NCCCache) and float(gs.measure_cache.c) == 3.0


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

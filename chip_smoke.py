#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--size 256] [--seed 0]

Phases, each printing one JSON line (any failure exits non-zero):

1. device : the card's name, count and power limit.
2. build  : nvcc of every ``src/repro_torch/csrc/*.cu`` for sm_90a, in
            parallel, with ptxas' registers and spills per kernel.
3. kernels: each kernel against its plain PyTorch version on the same
            inputs at size^3 (K1 FD8 per axis and the prefilter on K=2 and
            K=3 stacks; K2 with K=1 and K=3 on a cubic plan from the
            footpoints of a smooth velocity; K3 with both epilogues).
4. reference: a 16^3 registration on the card against the same
            registration through the plain versions on the CPU.
5. matvec : the plan-path and the fused (K3) Gauss-Newton matvec on one
            size^3 GradientState, <= 1e-5 * max(scale, 1).
6. solve  : ``register`` of the size^3 synthetic pair (fd8-cubic,
            use_fused_matvec=True) with every launch count set to 0 just
            before and read just after; each kernel of the path must have
            launched and no plain version may have run.
7. times  : each kernel at its main-path shape (CUDA events after warm-up)
            beside its bound, its plain version and the library call that
            computes the same function, where there is one.
8. profile: the solve once more under torch.profiler: device time by kernel
            group and the device's idle share of phase 6's wall time.

Then the ``nvidia-smi`` name/power-limit line, a JSON line ``{"kernels":
[...]}`` and, last, ``{"ok": true, "device": {...}}``. Without a CUDA card,
or without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 non-tensor flop/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

K1_RTOL, K1_ATOL = 1e-5, 1e-4
PLAN_REL = 1e-5            # K2/K3: max|kernel - plain| <= 1e-5 * max(|plain|, 1)
MATVEC_REL = 1e-5          # fused vs plan matvec, as tests/test_fused_matvec.py
REF_V_REL = 1e-4           # 16^3 solve, card vs CPU: max|dv| <= 1e-4 * max|v|
TIMING_REPS, PLAIN_REPS = 20, 2

KERNELS = {
    # name: (source, Pallas kernel it replaces)
    "stencil_axis:fd8": ("src/repro_torch/csrc/pencil.cu",
                         "src/repro/kernels/pencil.py:135"),
    "stencil_axis:prefilter": ("src/repro_torch/csrc/pencil.cu",
                               "src/repro/kernels/pencil.py:135"),
    "apply_plan": ("src/repro_torch/csrc/interp3d.cu",
                   "src/repro/kernels/interp3d/interp3d.py:247"),
    "apply_plan_fused:inc_state": ("src/repro_torch/csrc/interp3d.cu",
                                   "src/repro/kernels/interp3d/interp3d.py:339"),
    "apply_plan_fused:inc_adjoint": ("src/repro_torch/csrc/interp3d.cu",
                                     "src/repro/kernels/interp3d/interp3d.py:339"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps(dict(phase=phase, **fields)), flush=True)


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def timed(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, one warm-up call first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def plan_bytes(plan) -> int:
    return nbytes(*plan.idx, *plan.weights)


def circular_conv(taps, symmetric: bool, scale: float, axis: int, device):
    """A ``torch.nn.Conv3d`` with circular padding computing the same periodic
    stencil (the library yardstick of K1; the port never calls it)."""
    import torch

    r = len(taps) - 1 if symmetric else len(taps)
    w = torch.zeros(2 * r + 1, dtype=torch.float64)
    if symmetric:
        w[r] = taps[0]
        for k in range(1, r + 1):
            w[r + k] = w[r - k] = taps[k]
    else:
        for k in range(1, r + 1):
            w[r + k] = taps[k - 1]
            w[r - k] = -taps[k - 1]
    ksize = [1, 1, 1]
    ksize[axis] = 2 * r + 1
    pad = [0, 0, 0]
    pad[axis] = r
    conv = torch.nn.Conv3d(1, 1, tuple(ksize), padding=tuple(pad),
                           padding_mode="circular", bias=False)
    with torch.no_grad():
        conv.weight.copy_((w * scale).reshape(1, 1, *ksize))
    return conv.to(device).requires_grad_(False)


def _kernel_group(key: str) -> str:
    for group, marks in (("K1 stencil_axis", ("stencil_axis",)),
                         ("K3 apply_plan_fused", ("apply_plan_fused",)),
                         ("K2 apply_plan", ("apply_plan_kernel",)),
                         ("cuFFT", ("fft",)),
                         ("reductions", ("reduce",)),
                         ("cuBLAS gemv", ("gemv",)),
                         ("elementwise / copies", ("elementwise", "copy", "Memcpy",
                                                   "Memset", "fill", "cat"))):
        if any(m in key for m in marks):
            return group
    return "other"


def profile_solve(pair, dev, unprofiled_wall_s: float) -> None:
    """The main-path solve once more under torch.profiler: device time by
    kernel group and the device's idle share of the unprofiled wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import registration as R

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        R.register(pair.m0, pair.m1, variant="fd8-cubic", use_fused_matvec=True,
                   device=dev)
        torch.cuda.synchronize()
    profiled_wall = time.perf_counter() - t0
    groups, top = {}, []
    for ev in prof.key_averages():
        # Kernel events only: operator events repeat their kernels' time.
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us <= 0:
            continue
        g = _kernel_group(ev.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top.append((us / 1e3, ev.count, ev.key[:90]))
    device_ms = sum(groups.values())
    top.sort(reverse=True)
    emit("profile", device_ms=device_ms, profiled_wall_s=profiled_wall,
         unprofiled_wall_s=unprofiled_wall_s,
         idle_share=1.0 - device_ms / 1e3 / unprofiled_wall_s if device_ms else None,
         groups_ms=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
         top=[dict(ms=ms, count=c, kernel=k) for ms, c, k in top[:12]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    from repro_torch import device as D
    from repro_torch.core import gradient as GR
    from repro_torch.core import hessian as HS
    from repro_torch.core import interp as I
    from repro_torch.core import registration as R
    from repro_torch.core import semilag as SL
    from repro_torch.data import synthetic as S
    from repro_torch.kernels import _build, counts
    from repro_torch.kernels import fd8 as FD8
    from repro_torch.kernels import interp3d as K
    from repro_torch.kernels import pencil as P
    from repro_torch.kernels import prefilter as PF

    dev = D.resolve("cuda")
    n = args.size
    shape = (n, n, n)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi gave no output"

    # 1. device
    emit("device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi_line,
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, dir=str(_build.build_dir()),
         nvcc={k: v for k, v in _build.BUILD_LOG.items()})

    # 3. kernels vs plain at size^3
    gen = torch.Generator().manual_seed(args.seed)
    f = torch.randn(shape, generator=gen).to(dev)
    stack2 = torch.randn((2,) + shape, generator=gen).to(dev)
    stack3 = torch.randn((3,) + shape, generator=gen).to(dev)
    errs = {}
    checks = []

    def k1_check(label, got, ref):
        err = max_err(got, ref)
        ok = bool(((got - ref).abs() <= K1_ATOL + K1_RTOL * ref.abs()).all())
        checks.append(dict(case=label, max_abs_err=err, ok=ok))
        return err

    errs["stencil_axis:fd8"] = max(
        k1_check(f"fd8 axis {a}", FD8.fd8_partial(f, a),
                 P.stencil_axis_plain(f, a, FD8.FD8_COEFFS, False,
                                      1.0 / (2 * math.pi / n)))
        for a in range(3))

    def prefilter_plain(x):
        for a in range(3):
            x = P.stencil_axis_plain(x, a, PF.PREFILTER_TAPS, True, 1.0)
        return x

    errs["stencil_axis:prefilter"] = max(
        k1_check(f"prefilter K={s.shape[0]}", PF.prefilter3d(s), prefilter_plain(s))
        for s in (stack2, stack3))

    v_smooth = S.random_velocity(gen, shape, amplitude=0.6, device=dev)
    foot = SL.trace_characteristic(v_smooth, 0.25, "cubic_bspline", 1.0)
    plan = I.build_plan(foot, "cubic_bspline")

    def plan_check(label, got, ref):
        err = max_err(got, ref)
        tol = PLAN_REL * max(float(ref.abs().max()), 1.0)
        checks.append(dict(case=label, max_abs_err=err, tol=tol, ok=err <= tol))
        return err

    coef1 = PF.prefilter3d(f)
    coef3 = PF.prefilter3d(stack3)
    errs["apply_plan"] = max(
        plan_check("apply_plan K=1", K.apply_plan(coef1, plan),
                   K.apply_plan_plain(coef1, plan)),
        plan_check("apply_plan K=3", K.apply_plan(coef3, plan),
                   K.apply_plan_plain(coef3, plan)))
    coef2 = PF.prefilter3d(stack2)
    extra = stack3[0]
    for epi in ("inc_state", "inc_adjoint"):
        errs["apply_plan_fused:" + epi] = plan_check(
            "apply_plan_fused " + epi,
            K.apply_plan_fused(coef2, plan, extra, epi, 0.25),
            K.apply_plan_fused_plain(coef2, plan, extra, epi, 0.25))
    torch.cuda.synchronize()
    ok3 = all(c["ok"] for c in checks)
    emit("kernels", size=n, ok=ok3, checks=checks,
         tolerances=dict(k1_rtol=K1_RTOL, k1_atol=K1_ATOL, plan_rel=PLAN_REL))
    if not ok3:
        return 1

    # 4. reference: 16^3 solve on the card vs the plain versions on the CPU
    small = S.make_pair(args.seed, (16, 16, 16), device="cpu")
    ref = R.register(small.m0, small.m1, device="cpu")
    got = R.register(small.m0, small.m1, use_fused_matvec=True, device=dev)
    dv = max_err(got.v.cpu(), ref.v)
    vmax = float(ref.v.abs().max())
    pcg_ref = [h["pcg_iters"] for h in ref.history]
    pcg_got = [h["pcg_iters"] for h in got.history]
    ok4 = (got.iters == ref.iters and pcg_got == pcg_ref
           and got.converged == ref.converged and dv <= REF_V_REL * vmax)
    emit("reference", ok=ok4, iters=[got.iters, ref.iters], pcg=[pcg_got, pcg_ref],
         max_abs_dv=dv, tol=REF_V_REL * vmax,
         mismatch_rel=[got.mismatch_rel, ref.mismatch_rel])
    if not ok4:
        return 1

    # 5. matvec: plan path vs fused path on one size^3 GradientState
    pair = S.make_pair(args.seed, shape, device=dev)
    beta, gamma = 5e-4, 1e-4
    v = 0.3 * S.random_velocity(gen, shape, device=dev)
    vt = S.random_velocity(gen, shape, amplitude=0.2, device=dev)
    cfg = R.make_transport_config("fd8-cubic")
    cfg_f = R.make_transport_config("fd8-cubic", use_fused_matvec=True)
    gs = GR.evaluate(pair.m0, pair.m1, v, beta, gamma, cfg)
    hv_plan = HS.matvec(vt, gs, v, beta, gamma, cfg)
    hv_fused = HS.matvec(vt, gs, v, beta, gamma, cfg_f)
    scale = float(hv_plan.abs().max())
    dev_mv = max_err(hv_fused, hv_plan)
    ok5 = bool(math.isfinite(scale)) and dev_mv <= MATVEC_REL * max(scale, 1.0)
    emit("matvec", ok=ok5, max_abs_dev=dev_mv, scale=scale,
         tol=MATVEC_REL * max(scale, 1.0))
    if not ok5:
        return 1
    del gs, hv_plan, hv_fused, v, vt

    # 6. solve: the main path, with every count set to 0 just before it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    t0 = time.perf_counter()
    res = R.register(pair.m0, pair.m1, variant="fd8-cubic",
                     use_fused_matvec=True, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.snapshot()
    plain_runs = {k: c for k, c in launches.items() if k.startswith("plain:")}
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    ok6 = (not missing and not plain_runs and math.isfinite(res.mismatch_rel)
           and res.detF["min"] > 0 and bool(torch.isfinite(res.v).all())
           and tuple(res.v.shape) == (3,) + shape)
    emit("solve", ok=ok6, size=n, variant="fd8-cubic", use_fused_matvec=True,
         iters=res.iters, pcg_per_step=[h["pcg_iters"] for h in res.history],
         ls_evals=[h["ls_evals"] for h in res.history], matvecs=res.matvecs,
         mismatch_rel=res.mismatch_rel, detF=res.detF, converged=res.converged,
         rel_grad=res.rel_grad, solver_wall_s=res.wall_time_s,
         register_wall_s=wall, max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, missing=missing, plain_runs=plain_runs)
    if not ok6:
        return 1
    del res

    # 7. times at the main-path shapes
    reps, plain_reps = TIMING_REPS, PLAIN_REPS
    rows = {}
    fd8_scale = 1.0 / (2 * math.pi / n)
    fd8_ms = [timed(lambda a=a: FD8.fd8_partial(f, a), reps) for a in range(3)]
    fd8_plain = [timed(lambda a=a: P.stencil_axis_plain(f, a, FD8.FD8_COEFFS, False,
                                                         fd8_scale), plain_reps)
                 for a in range(3)]
    fd8_lib = []
    x5 = f[None, None]
    with torch.no_grad():
        for a in range(3):
            conv = circular_conv(FD8.FD8_COEFFS, False, fd8_scale, a, dev)
            fd8_lib.append(timed(lambda c=conv: c(x5), reps))
    rows["stencil_axis:fd8"] = dict(
        ms=sum(fd8_ms) / 3, plain_ms=sum(fd8_plain) / 3, library_ms=sum(fd8_lib) / 3,
        bound=bound_ms(2 * nbytes(f), 13 * f.numel()),
        shape=list(f.shape), per_axis_ms=fd8_ms)

    pf_ms = [timed(lambda a=a: P.stencil_axis(stack2, a, PF.PREFILTER_TAPS, True, 1.0),
                   reps) for a in range(3)]
    pf_plain = [timed(lambda a=a: P.stencil_axis_plain(stack2, a, PF.PREFILTER_TAPS,
                                                        True, 1.0), plain_reps)
                for a in range(3)]
    pf_lib = []
    s5 = stack2[:, None]
    with torch.no_grad():
        for a in range(3):
            conv = circular_conv(PF.PREFILTER_TAPS, True, 1.0, a, dev)
            pf_lib.append(timed(lambda c=conv: c(s5), reps))
    rows["stencil_axis:prefilter"] = dict(
        ms=sum(pf_ms) / 3, plain_ms=sum(pf_plain) / 3, library_ms=sum(pf_lib) / 3,
        bound=bound_ms(2 * nbytes(stack2), 23 * stack2.numel()),
        shape=list(stack2.shape), per_axis_ms=pf_ms)

    m = f.numel()
    rows["apply_plan"] = dict(
        ms=timed(lambda: K.apply_plan(coef1, plan), reps),
        plain_ms=timed(lambda: K.apply_plan_plain(coef1, plan), plain_reps),
        library_ms=None,
        bound=bound_ms(plan_bytes(plan) + 2 * nbytes(coef1), m * (16 + 192)),
        shape=list(coef1.shape),
        k3_ms=timed(lambda: K.apply_plan(coef3, plan), reps))
    for epi, epi_ops in (("inc_state", 3), ("inc_adjoint", 6)):
        rows["apply_plan_fused:" + epi] = dict(
            ms=timed(lambda e=epi: K.apply_plan_fused(coef2, plan, extra, e, 0.25), reps),
            plain_ms=timed(lambda e=epi: K.apply_plan_fused_plain(coef2, plan, extra,
                                                                  e, 0.25), plain_reps),
            library_ms=None,
            bound=bound_ms(plan_bytes(plan) + nbytes(coef2, extra) + 4 * m,
                           m * (16 + 2 * 192 + epi_ops)),
            shape=list(coef2.shape))
    emit("times", size=n, reps=reps, plain_reps=plain_reps, rows=rows)

    # 8. profile: device time by kernel group, and the idle share
    profile_solve(pair, dev, wall)

    kernels = []
    for kname, (src, replaces) in KERNELS.items():
        row = rows[kname]
        kernels.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=launches.get(kname, 0), max_abs_err=errs[kname],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound"][0],
            bound_by=row["bound"][1], library_ms=row["library_ms"]))
    print(smi_line)
    print(json.dumps(dict(kernels=kernels)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

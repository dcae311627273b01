"""Multi-pod dry-run: every (architecture x input shape) cell on the
production meshes, and the registration cells, as counts of one rank's
memory, FLOPs, bytes and collective bytes (port of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --jobs 4 --out results/dryrun_torch.jsonl
    python -m repro_torch.launch.dryrun --claire claire_256_ensemble --claire-mode slab --mesh multi
    python -m repro_torch.launch.dryrun --list

JAX lowers and compiles each cell on 256 or 512 fake host devices and reads
XLA's memory analysis and optimised HLO. PyTorch has no such compiler, so
the port runs rank 0's real step on tensors without storage:

  * the ranks are a ``torch.distributed`` world of the mesh's size on the
    ``fake`` backend (``FakeStore``), in this one process, rank 0; every
    collective returns at once with the right shapes;
  * the step is the one a user runs: ``train.steps``' train, prefill and
    decode steps on rank 0's param, ZeRO-1 and cache blocks; for
    registration, the pieces of the Newton step (below);
  * every tensor is a fake tensor (``FakeTensorMode``) of device
    :data:`DEVICE`. No byte is allocated on any device, so the dry-run runs
    the same code on any machine and takes no ``--device``. The kernel
    wrappers take their fake route (``kernels.counts``): the kernel's
    checks, its output's shape, its launch counted with its FLOPs and bytes;
  * ``roofline.counts.count`` counts FLOPs (``FlopCounterMode``'s formulas),
    elementwise FLOPs, bytes read and written and collective bytes by kind;
    ``MemTracker`` (``torch.distributed._tools``) the peak of live tensors.

The registration cell is JAX's: one Newton step with a gradient, a 6-matvec
PCG budget and one line-search trial (``GNConfig(max_pcg=6, ls_max=1)``).
The step's loops decide on host reads, which a fake tensor has not, so
each piece that holds no host decision runs once and the step is composed:
gradient + PCG set-up + 6 x (matvec + preconditioner + PCG update) +
objective + line-search update. ``ensemble`` runs rank 0's pairs (the pair
axis over every mesh axis that divides it: no collective), ``slab`` one
pair in x1 slabs over ``model`` (halo exchanges, spectral all-gathers,
all-reduced inner products).

A record is JSON with JAX's keys where the meaning carries over:
``memory.{argument,output,temp,alias,peak}_bytes`` (peak: MemTracker's,
arguments included; temp = peak - argument - output + alias), with
``memory.capacity_bytes`` and ``memory.fits`` (the peak within an H100's
80 GB); ``collectives_by_kind``; ``roofline.*`` from ``roofline_terms`` and
``model_flops`` with the H100's peaks. It adds ``run_s`` (the fake step's
wall time, in place of ``lower_s`` / ``compile_s``),
``roofline.ew_flops_device`` and ``kernels`` (each kernel's fake launches,
FLOPs and bytes). JAX's ``xla_cost_analysis`` has no counterpart.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from functools import partial
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten

from ..configs import ARCHS, REGISTRATIONS, SHAPES
from ..distributed import sharding as shd
from ..launch import mesh as mesh_lib
from ..models import build_model
from ..roofline import HBM_BYTES, model_flops, roofline_terms
from ..roofline import counts as RC
from ..train import steps as tsteps

#: long_500k needs a sub-quadratic sequence path; the pure full-attention
#: archs have none (recorded skips, as in JAX)
LONG_CAPABLE = {"mamba2-780m", "jamba-v0.1-52b"}
#: The fake tensors' device. Autograd of a fake ``cuda`` tensor needs CUDA's
#: device guard, which a CPU-only build of PyTorch lacks (the process
#: aborts), so the dry-run's tensors say ``cpu`` on every build. No code of
#: the port branches on the device but the kernel wrappers, and they take
#: the kernel's route for any fake tensor.
DEVICE = "cpu"
#: JAX's registration cell: one gradient, 6 PCG matvecs, one trial
GN_CELL = dict(max_pcg=6, ls_max=1)
SLAB_HALO = 6

_SKIP_MSG = "skipped: full-attention arch has no sub-quadratic path at 500k"


def cell_is_skipped(arch: str, shape: str) -> bool:
    return shape == "long_500k" and arch not in LONG_CAPABLE


def cell_refusal(arch: str, shape: str, mesh_kind: str) -> Optional[str]:
    """The recorded skip of a cell the port's step refuses, or None: a MoE
    decode whose rows split over the data axes regroups its routing group
    (``train.steps.moe_decode_refusal``; GSPMD routes the whole group in
    JAX)."""
    shape_cfg = SHAPES[shape]
    if shape_cfg.kind != "decode":
        return None
    prod = mesh_lib.make_production_mesh(multi_pod=(mesh_kind == "multi"))
    why = tsteps.moe_decode_refusal(ARCHS[arch], prod, shape_cfg.global_batch)
    return f"skipped: the port's decode step refuses it: {why}" if why else None


# ---------------------------------------------------------------------------
# The fake world and the counters
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(shape, axes):
    """A world of ``prod(shape)`` ranks on the ``fake`` backend in this
    process, rank 0, with a mesh of ``shape`` over ``axes`` on it; the world
    is destroyed on exit."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run's fake world needs a process without a "
                           "torch.distributed group")
    shape, axes = tuple(shape), tuple(axes)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    try:
        dm = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        yield mesh_lib.Mesh(shape, axes, dm)
    finally:
        dist.destroy_process_group()


def fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def fake_like(tree):
    """Fake tensors of :data:`DEVICE` with the shapes and dtypes of a tree of
    tensors or ``TensorSpec`` leaves (inside a fake mode)."""
    return _map(lambda t: torch.zeros(tuple(t.shape), dtype=t.dtype, device=DEVICE), tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    if isinstance(tree, tuple) and not hasattr(tree, "shape"):
        return type(tree)(*(_map(fn, v) for v in tree))
    return fn(tree)


class Measured(NamedTuple):
    out: object
    costs: RC.Costs
    by_site: Dict[str, RC.Costs]
    kernels: Dict[str, Dict[str, float]]   # name -> launches, flops, bytes
    peak_bytes: int
    run_s: float


def count(fn, sites: bool = False) -> Measured:
    """``fn()`` under the cost counter (its peak is left to the caller's
    ``MemTracker``)."""
    t0 = time.perf_counter()
    with RC.count(sites=sites) as c:
        out = fn()
    return Measured(out, c.costs, dict(c.by_site), c.kernels, 0, time.perf_counter() - t0)


def measure(fn, external, sites: bool = False) -> Measured:
    """``fn()`` under the cost counter and a ``MemTracker`` that knows the
    tensors of ``external`` (the step's arguments) from the start."""
    from torch.distributed._tools.mem_tracker import MemTracker

    mt = MemTracker()
    mt.track_external(*_tensors(external))
    with mt:
        m = count(fn, sites)
    return m._replace(peak_bytes=peak_of(mt))


def peak_of(tracker) -> int:
    return int(sum(d["Total"] for d in tracker.get_tracker_snapshot("peak").values()))


def memory_record(argument: int, output: int, alias: int, peak: int) -> dict:
    cap = HBM_BYTES
    return dict(argument_bytes=int(argument), output_bytes=int(output),
                temp_bytes=int(max(peak - argument - output + alias, 0)),
                alias_bytes=int(alias), peak_bytes=int(peak), capacity_bytes=int(cap),
                fits=bool(peak <= cap))


def _alias_bytes(inputs, outputs) -> int:
    ids = {id(t) for t in _tensors(inputs)}
    return sum(t.numel() * t.element_size() for t in _tensors(outputs) if id(t) in ids)


def roofline_record(costs: RC.Costs, chips: int, mf: float) -> dict:
    rl = roofline_terms(costs.flops, costs.mem_bytes, costs.coll_bytes, chips, mf)
    return dict(hlo_flops_device=costs.flops, ew_flops_device=costs.ew_flops,
                hlo_bytes_device=costs.mem_bytes, collective_bytes_device=costs.coll_bytes,
                compute_s=rl.compute_s, memory_s=rl.memory_s, collective_s=rl.collective_s,
                bound=rl.bound, model_flops=mf, useful_ratio=rl.useful_ratio,
                step_s=rl.step_s, roofline_fraction=rl.roofline_fraction)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _rows_bytes(batch, mesh) -> int:
    """The bytes of this rank's rows of a global batch (the step's own
    split: ``batch_specs``' dim 0)."""
    specs = shd.batch_specs(batch, mesh)
    total = 0
    for k, t in batch.items():
        spec = shd.P(specs[k][0])
        total += t.element_size() * math.prod(shd.local_shape(tuple(t.shape), spec, mesh))
    return total


def lm_step(model, shape_cfg, mesh, sites: bool = False):
    """Rank 0's step of one LM cell on ``mesh`` (inside a fake world and a
    fake mode): ``(Measured, memory record)``."""
    kind = shape_cfg.kind
    specs = model.input_specs(shape_cfg)
    if kind == "train":
        full = fake_like(tsteps.abstract_train_state(model))
        state = tsteps.shard_state(full, tsteps.state_specs(model, mesh), mesh)
        batch = fake_like(specs["batch"])
        step = tsteps.make_train_step(model, mesh)
        m = measure(lambda: step(state, batch), state, sites)
        args = nbytes(state) + _rows_bytes(batch, mesh)
        return m, memory_record(args, nbytes(m.out), 0, m.peak_bytes)
    params = tsteps.shard_params(fake_like(tsteps.abstract_train_state(model).params), mesh)
    if kind == "prefill":
        batch = fake_like(specs["batch"])
        step = tsteps.make_prefill_step(model, mesh)
        m = measure(lambda: step(params, batch), params, sites)
        args = nbytes(params) + _rows_bytes(batch, mesh)
        return m, memory_record(args, nbytes(m.out), 0, m.peak_bytes)
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    cache = tsteps.shard_cache(fake_like(specs["cache"]), mesh)
    tokens = fake_like(specs["tokens"])
    step = tsteps.make_decode_step(model, mesh, b, s)
    m = measure(lambda: step(params, cache, tokens, s - 1), [params, cache], sites)
    args = nbytes(params) + nbytes(cache) + _rows_bytes({"tokens": tokens}, mesh)
    return m, memory_record(args, nbytes(m.out), _alias_bytes(cache, m.out), m.peak_bytes)


def lm_cell(cfg, shape_cfg, mesh_shape, mesh_axes, sites: Optional[dict] = None) -> dict:
    """The record of ``cfg`` at ``shape_cfg`` on a fake world of
    ``mesh_shape`` over ``mesh_axes``; ``sites``, when given, is filled with
    the costs by source site."""
    chips = math.prod(mesh_shape)
    with fake_world(mesh_shape, mesh_axes) as mesh, fake_mode():
        model = build_model(cfg, DEVICE)
        m, mem = lm_step(model, shape_cfg, mesh, sites is not None)
    if sites is not None:
        sites.update(m.by_site)
    mf = model_flops(cfg, shape_cfg)
    return dict(chips=chips, kind=shape_cfg.kind, status="ok", run_s=round(m.run_s, 2),
                memory=mem,
                collectives_by_kind={k: round(v) for k, v in m.costs.coll_by_kind.items()},
                roofline=roofline_record(m.costs, chips, mf), kernels=m.kernels)


def run_cell(arch: str, shape: str, mesh_kind: str, sites: Optional[dict] = None) -> dict:
    prod = mesh_lib.make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rec = lm_cell(ARCHS[arch], SHAPES[shape], tuple(prod.shape.values()), prod.axis_names,
                  sites)
    return dict(arch=arch, shape=shape, mesh=mesh_kind, **rec)


# ---------------------------------------------------------------------------
# Registration cells
# ---------------------------------------------------------------------------

#: the pieces of one Newton step and how often the cell's step runs each
def step_weights(max_pcg: int = GN_CELL["max_pcg"]) -> Dict[str, int]:
    return {"gradient": 1, "pcg_setup": 1, "matvec": max_pcg, "preconditioner": max_pcg,
            "pcg_update": max_pcg, "objective": 1, "line_search": 1}


def newton_pieces(local_shape, cfg, beta: float, gamma: float, sites: bool = False):
    """Each piece of one Newton step run once on fake fields of this rank's
    ``local_shape`` (inside a fake mode; a fake world when ``cfg.shard``):
    ``(pieces {name: Measured}, peak bytes, argument bytes, output bytes)``.
    The pieces run in the step's order, each result kept as long as the
    step keeps it, so the peak is the step's."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from ..core import gradient as _grad
    from ..core import grid as _grid
    from ..core import hessian as _hess
    from ..core import objective as _obj
    from ..core import pcg as _pcg

    shape = tuple(local_shape)
    m0, m1 = (torch.zeros(shape, device=DEVICE) for _ in range(2))
    v = torch.zeros((3,) + shape, device=DEVICE)
    shard = cfg.shard
    inner = partial(_grid.inner, shape=shape, shard=shard)
    precond = _pcg.make_reg_preconditioner(beta, gamma, shard=shard)
    mt = MemTracker()
    mt.track_external(m0, m1, v)
    pieces = {}

    def run(name, fn):
        m = count(fn, sites)
        pieces[name] = _merge(pieces[name], m) if name in pieces else m
        return m.out

    def gradient():
        gs = _grad.evaluate(m0, m1, v, beta, gamma, cfg)
        return gs, _grid.norm_l2(gs.g, shard=shard)

    def pcg_setup():
        b = -gs.g
        z = precond(b)
        bnorm = torch.sqrt(inner(b, b))
        return torch.zeros_like(b), b, z, inner(b, z), _pcg.residual(b, inner) > bnorm

    def line_search(vt, a):
        inner(gs.g, vt)
        return v + a * vt

    with mt:
        gs, _ = run("gradient", gradient)
        x, r, p, rz, _ = run("pcg_setup", pcg_setup)
        hp = run("matvec", lambda: _hess.matvec(p, gs=gs, v=v, beta=beta, gamma=gamma,
                                                cfg=cfg))
        x, r = run("pcg_update", lambda: _pcg.update(x, r, p, hp, rz, inner))
        run("pcg_update", lambda: _pcg.residual(r, inner))
        z = run("preconditioner", lambda: precond(r))
        p, rz = run("pcg_update", lambda: _pcg.direction(r, z, p, rz, inner))
        a = torch.ones((), device=DEVICE)
        run("objective", lambda: _obj.objective(m0, m1, v + a * x, beta, gamma, cfg))
        v_new = run("line_search", lambda: line_search(x, a))
    # the step's outputs: v_new and its eight scalars
    return pieces, peak_of(mt), nbytes([m0, m1, v]), nbytes(v_new) + 8 * 4


def _add_kernels(into: Dict[str, Dict[str, float]], kernels, mult: float = 1.0):
    for name, k in kernels.items():
        t = into.setdefault(name, dict(launches=0, flops=0.0, bytes=0.0))
        for f in t:
            t[f] += mult * k[f]
    return into


def _merge(a: Measured, b: Measured) -> Measured:
    by_site = {k: RC.Costs().add(c) for k, c in a.by_site.items()}
    for k, c in b.by_site.items():
        by_site.setdefault(k, RC.Costs()).add(c)
    kernels = _add_kernels(_add_kernels({}, a.kernels), b.kernels)
    return Measured(b.out, RC.Costs().add(a.costs).add(b.costs), by_site, kernels, 0,
                    a.run_s + b.run_s)


def compose(pieces: Dict[str, Measured], weights: Dict[str, int], times: int = 1):
    """(costs, kernels, by_site) of ``times`` steps composed from pieces."""
    costs = RC.Costs()
    kernels: Dict[str, Dict[str, float]] = {}
    by_site: Dict[str, RC.Costs] = {}
    for k, w in weights.items():
        costs.add(pieces[k].costs, w * times)
        _add_kernels(kernels, pieces[k].kernels, w * times)
        for s, c in pieces[k].by_site.items():
            by_site.setdefault(s, RC.Costs()).add(c, w * times)
    return costs, kernels, by_site


def claire_cell(rcfg, mode: str, mesh_shape, mesh_axes, sites: Optional[dict] = None) -> dict:
    """The record of one registration cell (``rcfg`` a ``RegistrationConfig``)
    on a fake world of ``mesh_shape`` over ``mesh_axes``."""
    from ..core import gauss_newton as _gn
    from ..core import transport as _tr
    from ..distributed import claire_dist as CD
    from ..distributed import halo as _halo

    chips = math.prod(mesh_shape)
    cfg = _tr.TransportConfig(interp="cubic_bspline", deriv="fd8", nt=rcfg.nt)
    gn = _gn.GNConfig(**GN_CELL)
    t0 = time.perf_counter()
    with fake_world(mesh_shape, mesh_axes) as mesh, fake_mode():
        if mode == "ensemble":
            batch = max(rcfg.ensemble, chips)
            img, _ = CD.ensemble_shardings(mesh, batch)
            pairs = shd.local_shape((batch,) + tuple(rcfg.grid), img, mesh)[0]
            local = tuple(rcfg.grid)
        elif mode == "slab":
            batch, pairs = 1, 1
            img, _ = CD.slab_shardings(mesh, rcfg.grid)
            local = shd.local_shape(tuple(rcfg.grid), img, mesh)
            if img[0] is not None and mesh.shape["model"] > 1:
                cfg = dataclasses.replace(cfg, shard=_halo.ShardInfo.of_group(
                    mesh.group(CD.slab_axis_name(mesh)), halo=SLAB_HALO))
        else:
            raise ValueError(f"claire mode {mode!r}: expected 'ensemble' or 'slab'")
        pieces, peak, args, outs = newton_pieces(local, cfg, rcfg.beta, rcfg.gamma,
                                                 sites is not None)
    weights = step_weights(gn.max_pcg)
    costs, kernels, by_site = compose(pieces, weights, pairs)
    if sites is not None:
        sites.update(by_site)
    # the rank's pairs run in turn: every pair's fields stay, one step's
    # working set at a time
    mem = memory_record(pairs * args, pairs * outs, 0, peak + (pairs - 1) * (args + outs))
    return dict(chips=chips, kind="registration", status="ok",
                run_s=round(time.perf_counter() - t0, 2), batch=batch, pairs_per_rank=pairs,
                local_grid=list(local), memory=mem,
                collectives_by_kind={k: round(v) for k, v in costs.coll_by_kind.items()},
                roofline=roofline_record(costs, chips, 0.0), kernels=kernels,
                composition=dict(weights=weights, pairs=pairs),
                pieces={k: dict(flops=p.costs.flops, ew_flops=p.costs.ew_flops,
                                mem_bytes=p.costs.mem_bytes, coll_bytes=p.costs.coll_bytes,
                                kernels=p.kernels) for k, p in pieces.items()})


def run_claire_cell(config_name: str, mode: str, mesh_kind: str,
                    sites: Optional[dict] = None) -> dict:
    """The paper's own workload on a production mesh: one Gauss-Newton step
    (``mode='ensemble'``: a batch of independent registrations over the
    mesh; ``mode='slab'``: one registration in x1 slabs over ``model``)."""
    prod = mesh_lib.make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rec = claire_cell(REGISTRATIONS[config_name], mode, tuple(prod.shape.values()),
                      prod.axis_names, sites)
    return dict(arch=config_name, shape=f"claire_{mode}", mesh=mesh_kind, **rec)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--claire", choices=sorted(REGISTRATIONS), default=None,
                    help="dry-run the registration workload instead")
    ap.add_argument("--claire-mode", choices=("ensemble", "slab"), default="ensemble")
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--jobs", type=int, default=1, help="parallel subprocesses for --all")
    args = ap.parse_args(argv)

    if args.list:
        for a in sorted(ARCHS):
            for s in sorted(SHAPES):
                skip = " (skip: no sub-quadratic path)" if cell_is_skipped(a, s) else ""
                if not skip and cell_refusal(a, s, "single"):
                    skip = " (skip: a MoE decode split over the data axes)"
                print(f"{a:22s} {s}{skip}")
        return 0

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.claire:
        rc = 0
        for m in meshes:
            try:
                rec = run_claire_cell(args.claire, args.claire_mode, m)
            except Exception as e:
                rec = dict(arch=args.claire, shape=f"claire_{args.claire_mode}", mesh=m,
                           status=f"error: {type(e).__name__}: {e}",
                           traceback=traceback.format_exc())
                rc = 1
            _record(rec, args.out)
        return rc

    if args.all:
        cells = [(a, s, m) for a in sorted(ARCHS) for s in sorted(SHAPES) for m in meshes]
        if args.jobs > 1:
            return _run_parallel(cells, args.out, args.jobs)
        rc = 0
        for a, s, m in cells:
            rc |= _run_one(a, s, m, args.out)
        return rc

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all / --list)")
    rc = 0
    for m in meshes:
        rc |= _run_one(args.arch, args.shape, m, args.out)
    return rc


def _record(rec: dict, out: Optional[str]):
    line = json.dumps(rec)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(line + "\n")
    r = rec.get("roofline", {})
    mem = rec.get("memory", {})
    status = rec.get("status")
    if status == "ok":
        print(f"[dryrun] {rec['arch']} x {rec['shape']} x {rec['mesh']}: OK "
              f"run={rec.get('run_s')}s "
              f"peak={mem.get('peak_bytes', 0) / 1e9:.2f}GB/dev fits={mem.get('fits')} "
              f"bound={r.get('bound')} "
              f"terms(c/m/x)={r.get('compute_s', 0):.3e}/{r.get('memory_s', 0):.3e}/"
              f"{r.get('collective_s', 0):.3e}s "
              f"useful={r.get('useful_ratio', 0):.2f}", flush=True)
    else:
        print(f"[dryrun] {rec['arch']} x {rec['shape']} x {rec['mesh']}: {status}", flush=True)


def _skip(arch: str, shape: str, mesh_kind: str) -> Optional[str]:
    return _SKIP_MSG if cell_is_skipped(arch, shape) else cell_refusal(arch, shape, mesh_kind)


def _run_one(arch: str, shape: str, mesh_kind: str, out: Optional[str]) -> int:
    skip = _skip(arch, shape, mesh_kind)
    if skip:
        _record(dict(arch=arch, shape=shape, mesh=mesh_kind, status=skip), out)
        return 0
    try:
        rec = run_cell(arch, shape, mesh_kind)
    except Exception as e:
        rec = dict(arch=arch, shape=shape, mesh=mesh_kind,
                   status=f"error: {type(e).__name__}: {e}",
                   traceback=traceback.format_exc())
        _record(rec, out)
        return 1
    _record(rec, out)
    return 0


def _run_parallel(cells, out, jobs) -> int:
    """One subprocess per cell, ``jobs`` at a time (each its own fake world)."""
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    pending = list(cells)
    running: list = []
    rc = 0
    while pending or running:
        while pending and len(running) < jobs:
            a, s, m = pending.pop(0)
            skip = _skip(a, s, m)
            if skip:
                _record(dict(arch=a, shape=s, mesh=m, status=skip), out)
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
                   "--shape", s, "--mesh", m]
            if out:
                cmd += ["--out", out]
            running.append(((a, s, m), subprocess.Popen(cmd, env=env)))
        done = [(k, p) for k, p in running if p.poll() is not None]
        for k, p in done:
            running.remove((k, p))
            rc |= p.returncode
        if running:
            time.sleep(0.5)
    return rc


if __name__ == "__main__":
    sys.exit(main())

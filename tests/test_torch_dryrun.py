"""The port's dry-run (``repro_torch.launch.dryrun``): rank 0's real step on
fake tensors in a fake ``torch.distributed`` world, counted by
``roofline.counts`` and ``MemTracker``.

The fake worlds run in subprocesses (``tests/_torch_dryrun_cells.py``;
a ``fake`` process group must not share a process with a gloo world), as
JAX's dry-run test runs its forced devices:

* the CLI on ``smollm-135m decode_32k --mesh multi``: rc 0, an OK line and
  every key of the record (JAX's ``test_dryrun_cell_end_to_end``), and
  ``roofline.debug`` on the same cell;
* a one-rank dry-run of a smoke train step counts the FLOPs that
  ``FlopCounterMode`` counts around the real step on the CPU;
* ``argument_bytes`` is the rank's blocks: ``state_specs`` (params and
  ZeRO-1) of the train state, ``param_specs`` and ``cache_specs`` of a
  decode, and the rank's rows of the batch;
* the ensemble cell moves no collective byte, the slab cell does, and the
  composed totals are the sums of their pieces;
* ``REPRO_RESIDUAL_SEQ=0`` takes the sequence gathers out of a (1, 4) TP
  cell (the all-reduces' share of its collective bytes rises) and raises
  its peak;
* each kernel wrapper's fake route: the kernel's checks, its output shape,
  one count under ``fake:<kernel>`` (the kernel's own count untouched) and
  its FLOPs and bytes.
"""

import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import interp as I
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import counts
from repro_torch.kernels import flashattn as FA
from repro_torch.kernels import interp3d as K
from repro_torch.kernels import pencil as P
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as ML
from repro_torch.models import build_model
from repro_torch.roofline import counts as RC
from repro_torch.roofline import debug as DBG
from repro_torch.train import steps as TS

import _torch_dryrun_cells as C

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
RECORD_KEYS = {"arch", "shape", "mesh", "chips", "kind", "status", "run_s", "memory",
               "collectives_by_kind", "roofline", "kernels"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "peak_bytes",
               "capacity_bytes", "fits"}
ROOFLINE_KEYS = {"hlo_flops_device", "ew_flops_device", "hlo_bytes_device",
                 "collective_bytes_device", "compute_s", "memory_s", "collective_s", "bound",
                 "model_flops", "useful_ratio", "step_s", "roofline_fraction"}


def _cells(tmp_path_factory, kind, **env):
    out = tmp_path_factory.mktemp("dryrun") / f"{kind}.json"
    res = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_dryrun_cells.py"), kind,
                          str(out)], env=dict(ENV, **env), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    return _cells(tmp_path_factory, "cells")


def test_cli_cell_end_to_end(tmp_path):
    out = tmp_path / "cells.jsonl"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "smollm-135m",
         "--shape", "decode_32k", "--mesh", "multi", "--out", str(out)],
        env=ENV, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "OK" in res.stdout and "bound=" in res.stdout
    rec = json.loads(out.read_text().splitlines()[-1])
    assert set(rec) == RECORD_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS and set(rec["roofline"]) == ROOFLINE_KEYS
    assert rec["chips"] == 512 and rec["status"] == "ok" and rec["memory"]["fits"]
    assert rec["roofline"]["hlo_flops_device"] > 0 and rec["roofline"]["step_s"] > 0
    assert rec["collectives_by_kind"]


def test_debug_breaks_a_cell_down_by_site():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.roofline.debug", "--arch", "smollm-135m",
         "--shape", "decode_32k", "--mesh", "multi", "5"],
        env=ENV, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    for title in ("FLOPs", "elementwise FLOPs", "memory bytes", "collective bytes"):
        assert f"== top {title} (per device) ==" in res.stdout
    assert "models/" in res.stdout and "c10d." in res.stdout


def test_debug_breakdown_files_each_cost_under_its_site():
    a, b = torch.randn(16, 8), torch.randn(8, 4)
    with RC.count(sites=True) as c:
        (a @ b).exp()
    flops, ew, mem, coll = DBG.breakdown(c.by_site)
    assert sum(flops.values()) == c.costs.flops == 2 * 16 * 8 * 4
    assert sum(ew.values()) == c.costs.ew_flops == 16 * 4
    assert sum(mem.values()) == c.costs.mem_bytes and not coll
    assert any("aten.mm" in k for k in flops)


def test_one_rank_dryrun_counts_the_flops_of_the_real_step(cells):
    model = build_model(C.smoke("smollm-135m"), "cpu")
    state = TS.init_train_state(model, torch.Generator().manual_seed(0))
    batch = model.make_batch(torch.Generator().manual_seed(1), C.SMOKE_TRAIN)["batch"]
    with FlopCounterMode(display=False) as fc:
        TS.make_train_step(model, None)(state, batch)
    rec = cells["one_rank_train"]
    assert rec["roofline"]["hlo_flops_device"] == fc.get_total_flops() > 0
    assert rec["collectives_by_kind"] == {} and rec["kernels"] == {}


def _block_bytes(tree, specs, mesh):
    return sum(torch.empty((), dtype=t.dtype).element_size()
               * math.prod(shd.local_shape(tuple(t.shape), s, mesh))
               for t, s in zip(_leaves(tree), _leaves(specs)))


def _leaves(tree):
    """Tensor, ``TensorSpec`` or spec leaves, in the tree's order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not (hasattr(tree, "shape")
                                                or isinstance(tree, shd.P)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rows_bytes(batch_specs, mesh):
    return sum(torch.empty((), dtype=s.dtype).element_size()
               * math.prod(shd.local_shape(s.shape, shd.P(shd._dp_entry(mesh, s.shape[0])),
                                           mesh)) for s in batch_specs.values())


def test_argument_bytes_are_the_ranks_blocks(cells):
    mesh = ML.Mesh(*C.MESH_2X2)
    model = build_model(C.smoke("smollm-135m"), "cpu")
    state = TS.abstract_train_state(model)
    want = (_block_bytes(state, TS.state_specs(model, mesh), mesh)
            + _rows_bytes(model.input_specs(C.MESH_TRAIN)["batch"], mesh))
    assert cells["train_2x2"]["memory"]["argument_bytes"] == want
    specs = model.input_specs(C.MESH_DECODE)
    cache = TS.cache_specs(model, mesh, C.MESH_DECODE.global_batch, C.MESH_DECODE.seq_len)
    want = (_block_bytes(state.params, shd.param_specs(state.params, mesh), mesh)
            + _block_bytes(specs["cache"], cache, mesh)
            + _rows_bytes({"tokens": specs["tokens"]}, mesh))
    assert cells["decode_2x2"]["memory"]["argument_bytes"] == want
    one = ML.Mesh((1, 1), ("data", "model"))
    want = (_block_bytes(state, TS.state_specs(model, one), one)
            + _rows_bytes(model.input_specs(C.SMOKE_TRAIN)["batch"], one))
    assert cells["one_rank_train"]["memory"]["argument_bytes"] == want
    for rec in cells.values():
        m = rec["memory"]
        assert m["peak_bytes"] == m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"] \
            - m["alias_bytes"]


def test_ensemble_moves_no_collective_byte_and_slab_does(cells):
    ens, slab = cells["ensemble"], cells["slab"]
    assert ens["collectives_by_kind"] == {} and ens["roofline"]["collective_bytes_device"] == 0
    assert ens["pairs_per_rank"] == 2 and ens["local_grid"] == [16, 16, 16]
    assert slab["local_grid"] == [4, 16, 16]
    assert slab["roofline"]["collective_bytes_device"] > 0
    assert {"all-gather", "collective-permute", "all-reduce"} <= set(slab["collectives_by_kind"])
    assert slab["kernels"]["stencil_valid:fd8"]["launches"] > 0
    assert "stencil_valid:fd8" not in ens["kernels"]


@pytest.mark.parametrize("cell", ["ensemble", "slab"])
def test_composed_totals_are_the_sums_of_their_pieces(cells, cell):
    rec = cells[cell]
    w, pairs = rec["composition"]["weights"], rec["composition"]["pairs"]
    assert w == D.step_weights() and w["matvec"] == 6
    pieces = rec["pieces"]
    for key, field in (("hlo_flops_device", "flops"), ("ew_flops_device", "ew_flops"),
                       ("hlo_bytes_device", "mem_bytes"),
                       ("collective_bytes_device", "coll_bytes")):
        want = sum(pairs * w[k] * pieces[k][field] for k in w)
        assert rec["roofline"][key] == pytest.approx(want, rel=1e-12)
    kernels = {}
    for k in w:
        for name, kc in pieces[k]["kernels"].items():
            t = kernels.setdefault(name, dict(launches=0, flops=0.0, bytes=0.0))
            for f in t:
                t[f] += pairs * w[k] * kc[f]
    assert rec["kernels"] == kernels


def test_residual_whole_drops_the_seq_gathers_and_raises_the_peak(cells, tmp_path_factory):
    split = cells["tp"]
    whole = _cells(tmp_path_factory, "tp", REPRO_RESIDUAL_SEQ="0")["tp"]

    def share(rec):
        kinds = rec["collectives_by_kind"]
        return kinds.get("all-reduce", 0) / sum(kinds.values())

    assert whole["collectives_by_kind"]["all-gather"] < split["collectives_by_kind"]["all-gather"]
    assert share(whole) > share(split)
    assert "reduce-scatter" not in whole["collectives_by_kind"]
    assert whole["memory"]["peak_bytes"] > split["memory"]["peak_bytes"]


def test_skips_and_refusals_are_recorded():
    assert D.cell_is_skipped("qwen2-7b", "long_500k")
    assert not D.cell_is_skipped("mamba2-780m", "long_500k")
    assert "regroup" in D.cell_refusal("deepseek-moe-16b", "decode_32k", "single")
    assert D.cell_refusal("deepseek-moe-16b", "prefill_32k", "single") is None
    assert D.cell_refusal("qwen2-7b", "decode_32k", "multi") is None


def _fake_launch(fn):
    """``fn()`` in a fake mode: (output, launches, kernel costs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    seen = []

    def listen(name, flops, nbytes, tensor_core):
        seen.append((name, flops, nbytes, tensor_core))

    counts.reset()
    counts.add_listener(listen)
    try:
        with FakeTensorMode():
            out = fn()
            shape = tuple(out.shape)
    finally:
        counts.remove_listener(listen)
    launches = counts.snapshot()
    counts.reset()
    return shape, launches, seen


def _fake(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype)


def test_fake_routes_of_the_stencils():
    shape, launches, seen = _fake_launch(
        lambda: P.stencil_axis(_fake(2, 8, 8, 8), 1, (0.5, 0.25), symmetric=False))
    assert shape == (2, 8, 8, 8) and launches == {"fake:stencil_axis:fd8": 1}
    assert seen == [("stencil_axis:fd8", 1024 * 7.0, 2 * 1024 * 4.0, False)]
    shape, launches, seen = _fake_launch(
        lambda: P.stencil_valid(_fake(3, 16, 8, 8), 0, (1.0, 2.0, 3.0, 4.0)))
    assert shape == (3, 8, 8, 8) and launches == {"fake:stencil_valid:fd8": 1}
    assert seen[0][1:3] == (3 * 512 * 13.0, (3 * 1024 + 3 * 512) * 4.0)
    with pytest.raises(TypeError, match="float32"):
        _fake_launch(lambda: P.stencil_axis(_fake(8, 8, 8, dtype=torch.float64), 0, (1.0,),
                                            symmetric=True))


def test_fake_routes_of_the_gathers():
    def k2():
        q = torch.zeros((3, 8, 8, 8))
        return K.apply_plan(_fake(2, 8, 8, 8), I.build_plan(q, "cubic_bspline"))

    shape, launches, seen = _fake_launch(k2)
    assert shape == (2, 8, 8, 8)
    assert launches == {"fake:build_plan:cubic_bspline": 1, "fake:apply_plan": 1}
    # the plan's build: q read, 3 x 4 indices and weights written a point
    assert seen[0] == ("build_plan:cubic_bspline", 512 * 66.0, (3 + 24) * 512 * 4.0, False)
    assert seen[1][1] == 512 * 2 * (16 + 192)
    assert seen[1][2] == (2 * 512 + 2 * 512 + 6 * 4 * 512) * 4

    def k3():
        q = torch.zeros((3, 8, 8, 8))
        return K.apply_plan_fused(_fake(2, 8, 8, 8), I.build_plan(q, "cubic_bspline"),
                                  _fake(8, 8, 8), "inc_adjoint", 0.25)

    shape, launches, seen = _fake_launch(k3)
    assert shape == (8, 8, 8)
    assert launches == {"fake:build_plan:cubic_bspline": 1,
                        "fake:apply_plan_fused:inc_adjoint": 1}
    assert seen[1][1] == 512 * (2 * (16 + 192) + 6)

    shape, launches, seen = _fake_launch(
        lambda: K.interp3d(_fake(8, 8, 8), _fake(3, 4, 4, 4), "linear"))
    assert shape == (4, 4, 4) and launches == {"fake:interp3d:linear": 1}
    assert seen[0][1:3] == (64 * (9 + 4 + 24), (512 + 3 * 64 + 64) * 4.0)


def test_fake_route_of_flash_attention():
    q = lambda s: _fake(6, s, 64, dtype=torch.bfloat16)  # noqa: E731
    shape, launches, seen = _fake_launch(lambda: FA.flash_attention(q(32), q(32), q(32), True))
    assert shape == (6, 32, 64) and launches == {"fake:flash_attention": 1}
    assert seen == [("flash_attention", 4.0 * 64 * 6 * (32 * 33 / 2), 4 * 6 * 32 * 64 * 2.0,
                     True)]
    _, _, seen = _fake_launch(lambda: FA.flash_attention(q(8), q(32), q(32), True, q_offset=16))
    assert seen[0][1] == 4.0 * 64 * 6 * (8 * 16 + 8 * 9 / 2)
    with pytest.raises(ValueError, match="head size"):
        _fake_launch(lambda: FA.flash_attention(_fake(2, 8, 16), _fake(2, 8, 16),
                                                _fake(2, 8, 16)))


def test_real_tensors_keep_their_routes():
    counts.reset()
    f = torch.randn((8, 8, 8))
    P.stencil_axis(f, 0, (1.0, 0.5), symmetric=True)
    FA.flash_attention(*(torch.randn(2, 8, 16) for _ in range(3)))
    assert counts.snapshot() == {"plain:stencil_axis:prefilter": 1,
                                 "plain:flash_attention": 1}
    counts.reset()

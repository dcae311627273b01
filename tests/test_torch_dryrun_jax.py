"""The dry-run's FLOP count against JAX's: the dot FLOPs of one smoke
smollm-135m train step (2 x 32 tokens) on a (1, 1) mesh, as the port's
dry-run counts them in a fake world (``tests/_torch_dryrun_cells.py``, in a
subprocess) and as JAX's dry-run reads them from the compiled HLO
(``analyze_hlo(jit(step).lower(...).compile().as_text()).flops``, one
compile).

Tolerance 2.5%, measured: the port counts 47 185 920 FLOPs against JAX's
46 137 344 (+2.27%). The difference is 1 048 576 = 2 x 64 x 64 x 128, one
(d_model x d_ff) product of the step's 64 tokens. Both recompute each
layer in backward (``torch.utils.checkpoint``, ``jax.checkpoint``); most
likely XLA drops a recomputed product whose result backward does not read,
where ``torch.utils.checkpoint`` reruns the layer's whole forward.

JAX's train step runs on a mesh of ``Auto`` axes: ``jax.make_mesh``'s
default ``Explicit`` axes refuse its sharding constraints on JAX 0.9 (the
reference-side failures of ``test_models.py::test_arch_smoke_train_step``).
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest
from jax.sharding import AxisType

from repro.configs import ARCHS
from repro.models import build_model
from repro.roofline.hlo import analyze_hlo
from repro.train import steps as jsteps

import _torch_dryrun_cells as C

ROOT = pathlib.Path(__file__).resolve().parent.parent
FLOPS_RTOL = 0.025


@pytest.fixture(scope="module")
def port_record(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_jax") / "one_rank.json"
    res = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_dryrun_cells.py"),
                          "one_rank", str(out)], env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(out.read_text())["one_rank_train"]


@pytest.fixture(scope="module")
def jax_costs():
    model = build_model(ARCHS["smollm-135m"].smoke())
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    step, _ = jsteps.make_train_step(model, mesh)
    batch = model.input_specs(C.SMOKE_TRAIN)["batch"]
    text = jax.jit(step).lower(jsteps.abstract_train_state(model), batch).compile().as_text()
    return analyze_hlo(text)


def test_dot_flops_match_jax(port_record, jax_costs):
    got = port_record["roofline"]["hlo_flops_device"]
    assert jax_costs.flops > 0
    assert got == pytest.approx(jax_costs.flops, rel=FLOPS_RTOL)


def test_neither_step_moves_a_collective_byte(port_record, jax_costs):
    assert port_record["roofline"]["collective_bytes_device"] == 0
    assert jax_costs.coll_bytes == 0

"""The plain reference against the program at 16^3 on the CPU, and each
cell's control against the cell's limits."""

import json
from pathlib import Path

import pytest
import torch

from _cpu import failing, rehearse
from regbench import control, window as W
from regbench.generator import load, pool
from regbench.reference import claire as C
from regbench.reference import judge as J

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
CONTROLS = Path(__file__).resolve().parents[1] / "controls"
NAMES = ["claire-256-fp32-fused", "claire-256-bf16-planfree"]
#: the largest gap between the port and the reference at 16^3: fp32 to
#: rounding; bf16 weights that the port's fp32 arithmetic rounds the other
#: way now and then (8.2e-6 read on this pair)
AGREE = {"claire-256-fp32-fused": 1e-6, "claire-256-bf16-planfree": 1e-4}


@pytest.fixture(scope="module")
def pair():
    p = pool(load("solve-closed-1"), (16, 16, 16), 4, seed=11, dev="cpu")[0]
    return torch.from_numpy(p.m0), torch.from_numpy(p.m1)


@pytest.mark.parametrize("name", NAMES)
def test_the_reference_agrees_with_the_port(name, pair):
    from repro_torch.core import registration

    solver = json.loads((CONFIGS / f"{name}.json").read_text())["solver"]
    m0, m1 = pair
    port = registration.register(m0, m1, device="cpu", **W.solver_kwargs(solver))
    pb = J.problem(solver)
    nums = J.judge(m0, m1, port.v, dict(rel_grad=port.rel_grad, mismatch_rel=port.mismatch_rel,
                                        m_warped=port.m_warped, detF=port.detF),
                   pb, J.gnorm_cold(m0, m1, pb))
    assert port.converged and nums["rel_grad"] <= solver["tol_rel_grad"]
    assert max(v for k, v in nums.items() if k.endswith("_gap")) <= AGREE[name]
    ref = C.solve(m0, m1, pb)
    assert (ref.iters, ref.matvecs) == (port.iters, port.matvecs)
    assert float((ref.v - port.v).abs().max()) <= 1e-4 * float(port.v.abs().max())


@pytest.mark.parametrize("workload", ["claire256-fp32.solve", "claire256-bf16.solve",
                                      "claire256-fp32.serve"])
def test_the_control_fails_the_cells_limits(workload, capsys):
    ctl = json.loads((CONTROLS / f"{workload}.json").read_text())
    rc, line = rehearse(capsys, workload, program=control.program_of(ctl))
    assert rc == 0 and line["correct"] is False
    assert set(failing(line)) - {"rel_grad"}


def test_the_reference_agrees_with_the_port_under_ncc_on_an_inverted_pair():
    from repro_torch.core import registration

    mix = dict(load("solve-closed-1"))
    mix["pool"] = dict(mix["pool"], registrations=1, contrast="inverted")
    p = pool(mix, (16, 16, 16), 4, seed=11, dev="cpu")[0]
    m0, m1 = torch.from_numpy(p.m0), torch.from_numpy(p.m1)
    solver = dict(json.loads((CONFIGS / f"{NAMES[0]}.json").read_text())["solver"],
                  measure="ncc")
    port = registration.register(m0, m1, device="cpu", **W.solver_kwargs(solver))
    pb = J.problem(solver)
    nums = J.judge(m0, m1, port.v, dict(rel_grad=port.rel_grad, mismatch_rel=port.mismatch_rel,
                                        m_warped=port.m_warped, detF=port.detF),
                   pb, J.gnorm_cold(m0, m1, pb))
    assert port.converged and nums["rel_grad"] <= solver["tol_rel_grad"]
    assert max(v for k, v in nums.items() if k.endswith("_gap")) <= 1e-5
    ref = C.solve(m0, m1, pb)
    assert (ref.iters, ref.matvecs) == (port.iters, port.matvecs)

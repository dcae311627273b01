"""A run with the timed path broken underneath must come out not correct,
through the comparison: a step that returns its state unchanged, an answer
altered where it is produced, and (in the server's waves) half of a wave
left out. One card has no exchange between chips to leave out."""

import pytest

from _cpu import failing, rehearse
from regbench import generator

CELLS = ["claire256-fp32.solve", "claire256-bf16.solve", "claire256-fp32.serve"]
#: a short Newton cap keeps the broken solves short on the CPU
SHORT = {"solver": {"max_newton": 8}}


@pytest.fixture
def judge_every_answer(monkeypatch):
    """The server mix's sample widened to every answer, so that a fault in
    half of the lanes cannot hide outside the sample."""
    orig = generator.load

    def load(mix):
        d = orig(mix)
        d["sample"] = dict(d["sample"], answers=1000)
        return d

    monkeypatch.setattr(generator, "load", load)


@pytest.mark.parametrize("workload", CELLS)
def test_a_healthy_run_is_correct(workload, capsys):
    rc, line = rehearse(capsys, workload, program=SHORT)
    assert rc == 0 and line["correct"] is True, line


@pytest.mark.parametrize("workload", CELLS)
def test_a_step_that_returns_its_state_unchanged(workload, capsys, monkeypatch):
    from repro_torch.core import gauss_newton as gn

    step = gn.newton_step

    def stuck(m0, m1, v, *a, **kw):
        st = step(m0, m1, v, *a, **kw)
        st.v_new = v
        return st

    monkeypatch.setattr(gn, "newton_step", stuck)
    rc, line = rehearse(capsys, workload, program=SHORT)
    assert rc == 0 and line["correct"] is False
    assert "rel_grad" in failing(line)


@pytest.mark.parametrize("workload", CELLS)
def test_an_answer_altered_where_it_is_produced(workload, capsys, monkeypatch):
    from repro_torch.core import gauss_newton as gn

    name = "solve_batch" if workload.endswith(".serve") else "solve"
    orig = getattr(gn, name)

    def altered(*a, **kw):
        res = orig(*a, **kw)
        res.v = res.v * 1.05
        return res

    monkeypatch.setattr(gn, name, altered)
    rc, line = rehearse(capsys, workload, program=SHORT)
    assert rc == 0 and line["correct"] is False
    assert {"rel_grad_gap", "mismatch_gap"} & set(failing(line))


def test_half_of_a_wave_left_out(capsys, monkeypatch, judge_every_answer):
    from repro_torch.core import gauss_newton as gn

    orig = gn.solve_batch

    def half(*a, **kw):
        # every other lane left out, answered with its neighbour's velocity
        # (real lanes are never all on one side of a padded wave)
        res = orig(*a, **kw)
        res.v[1::2] = res.v[0::2].clone()
        return res

    monkeypatch.setattr(gn, "solve_batch", half)
    rc, line = rehearse(capsys, "claire256-fp32.serve", program=SHORT)
    assert rc == 0 and line["correct"] is False
    assert "rel_grad" in failing(line)

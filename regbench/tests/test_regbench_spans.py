"""The readers of the program's spans (``regbench/spans.py`` and the nine
metrics built on it) against numbers worked out by hand: a hand-made trace
whose idle gaps open inside and outside ``host.sync`` and ``gn.step`` spans,
hand-made spans, and the cases that must read None (no spans, a dropped
span, a program without the recorder)."""

import sys
import types

import pytest
from torch.profiler import ProfilerActivity, profile

from regbench import run as R
from regbench import spans as S
from regbench.trace import Trace
from repro_torch import obs

T = 1000.0                      # the window's clock origin, seconds
SOLVE = ("matvec_ms", "gradient_ms_per_solve", "linesearch_ms_per_solve",
         "plan_ms_per_solve", "host_syncs_per_solve", "sync_idle_ms_per_solve",
         "edge_idle_ms_per_solve")
SERVE = ("wave_wait_s_p50", "copy_ms_per_pair")


def _span(name, a, b, device_ms=None, thread="MainThread", **attrs):
    return obs.Span(name, 0, None, thread, round((T + a) * 1e9), round((T + b) * 1e9),
                    attrs, device_ms)


def _solve_spans():
    return [
        _span("register", 0.0, 10.0), _span("register", 10.5, 20.0),
        _span("gn.step", 1.0, 4.0), _span("gn.step", 11.0, 15.0),
        _span("host.sync", 2.0, 2.5), _span("host.sync", 12.0, 12.5),
        _span("host.sync", 8.0, 8.2),           # scoring: outside every step
        _span("host.sync", 18.9, 19.2),         # the caller's: outside every step
        _span("host.sync", 2.9, 3.1, thread="worker"),  # no step on its thread
        _span("pcg.matvec", 1.5, 1.6, device_ms=3.0),
        _span("pcg.matvec", 11.5, 11.6, device_ms=5.0),
        _span("gn.gradient", 1.0, 1.4, device_ms=10.0),
        _span("gn.gradient", 11.0, 11.4, device_ms=20.0),
        _span("gn.line_search", 3.5, 3.9, device_ms=4.0),
        _span("plan.build", 1.0, 1.1, device_ms=1.0),
        _span("plan.build", 1.1, 1.2, device_ms=1.0),
        _span("plan.build", 11.0, 11.1, device_ms=2.0),
    ]


def _solve_trace():
    """Gaps: (2.2, 2.4) in a step's sync; (3.0, 3.2), (11.9, 12.3) and
    (13.0, 13.5) in a step outside its syncs; (7.9, 8.1) outside the steps;
    (19.0, 19.5) in a sync outside the steps. The window's first 0.5 s are
    idle before its first operation."""
    ops = [(0.5, 2.2), (2.4, 3.0), (3.2, 7.9), (8.1, 11.9), (12.3, 13.0), (13.5, 19.0),
           (19.5, 20.0)]
    return Trace([("k", T + a, T + b) for a, b in ops], [], 20.0)


#: by hand: sync 0.2 s, rest 0.2 + 0.4 + 0.5 s, edge 0.2 + 0.5 + 0.5 s, two solves
WANT_SOLVE = dict(matvec_ms=4.0, gradient_ms_per_solve=15.0, linesearch_ms_per_solve=2.0,
                  plan_ms_per_solve=2.0, host_syncs_per_solve=2.5,
                  sync_idle_ms_per_solve=100.0, edge_idle_ms_per_solve=600.0)


def _serve_spans():
    return [
        _span("serve.wave_wait", 1.0, 2.0, wave_id=0, request_ids=(0, 1)),
        _span("serve.wave_wait", 5.0, 8.0, wave_id=1, request_ids=(2,)),
        _span("serve.h2d", 2.0, 2.2, wave_id=0, request_ids=(0, 1)),
        _span("serve.h2d", 8.0, 8.1, wave_id=1, request_ids=(2,)),
        _span("serve.d2h", 4.0, 4.05, wave_id=0, request_ids=(0, 1)),
    ]


#: the median of 1, 1, 3 s; 350 ms of copies over three requests
WANT_SERVE = dict(wave_wait_s_p50=1.0, copy_ms_per_pair=350.0 / 3)


def _run(trace=None, requests=()):
    return types.SimpleNamespace(trace=trace, requests=list(requests), solves=[{}, {}])


def _reads(monkeypatch, spans, run, names):
    monkeypatch.setattr(S, "recorded", lambda: spans)
    return {n: R._load_reader(n)(run) for n in names}


@pytest.fixture(autouse=True)
def _fresh():
    obs.clear()
    yield
    obs.clear()


def test_solve_readers_by_hand(monkeypatch):
    got = _reads(monkeypatch, _solve_spans(), _run(_solve_trace()), SOLVE)
    assert got == pytest.approx(WANT_SOLVE, rel=1e-6)


def test_idle_split_closes_over_the_gaps(monkeypatch):
    monkeypatch.setattr(S, "recorded", _solve_spans)
    trace = _solve_trace()
    split = S.idle_split(_run(trace))
    assert split == pytest.approx(dict(sync=0.1, rest=0.55, edge=0.6), rel=1e-6)
    assert sum(split.values()) == pytest.approx((trace.window_s - trace.busy_s) / 2)


def test_serve_readers_by_hand(monkeypatch):
    requests = [dict(wave_id=0), dict(wave_id=0), dict(wave_id=1), dict(wave_id=9)]
    got = _reads(monkeypatch, _serve_spans(), _run(requests=requests[:3]), SERVE)
    assert got == pytest.approx(WANT_SERVE, rel=1e-6)
    # a request whose wave has no wait span is left out of the median
    got = _reads(monkeypatch, _serve_spans(), _run(requests=requests), ["wave_wait_s_p50"])
    assert got["wave_wait_s_p50"] == pytest.approx(1.0)


def test_no_spans_read_none(monkeypatch):
    run = _run(_solve_trace(), [dict(wave_id=0)])
    assert set(_reads(monkeypatch, None, run, SOLVE + SERVE).values()) == {None}


def test_spans_without_their_kind_read_none(monkeypatch):
    """A plan-free path without plan builds, a solve window without a
    trace, a server window without copies, serve spans in a solve cell."""
    spans = [s for s in _solve_spans() if s.name != "plan.build"]
    assert _reads(monkeypatch, spans, _run(_solve_trace()),
                  ["plan_ms_per_solve"]) == {"plan_ms_per_solve": None}
    got = _reads(monkeypatch, _solve_spans(), _run(None), ["sync_idle_ms_per_solve",
                                                         "edge_idle_ms_per_solve"])
    assert set(got.values()) == {None}
    assert _reads(monkeypatch, _serve_spans(), _run(_solve_trace()), SOLVE) == dict.fromkeys(
        SOLVE)
    assert _reads(monkeypatch, _solve_spans(), _run(requests=[dict(wave_id=0)]),
                  SERVE) == dict.fromkeys(SERVE)


def test_recorded_reads_the_program(monkeypatch):
    assert S.recorded() is None                      # nothing recorded
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("register"):
            pass
    assert [s.name for s in S.recorded()] == ["register"]
    monkeypatch.setattr(obs, "CAP", 1)
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("register"):
            pass
    assert obs.dropped() == 1 and S.recorded() is None
    run = _run(_solve_trace(), [dict(wave_id=0)])
    assert {R._load_reader(n)(run) for n in SOLVE + SERVE} == {None}


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    """A program built before the recorder has no ``repro_torch.obs``: every
    reader returns None and none raises."""
    import repro_torch

    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert S.recorded() is None
    run = _run(_solve_trace(), [dict(wave_id=0)])
    assert {R._load_reader(n)(run) for n in SOLVE + SERVE} == {None}

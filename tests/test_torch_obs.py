"""The span recorder (``repro_torch.obs``) and the spans of a registration
and of the registration server, on the CPU at 16^3.

Off (no ``torch.profiler`` session in the process) nothing is recorded.
Under a session a registration records one ``register`` root, a ``gn.step``
and a ``gn.gradient`` per Newton evaluation, a ``pcg.matvec`` per Hessian
matvec and a ``host.sync`` per read of device values, every child inside
its parent and every stamp on the clock of kineto's own events. The server
puts each answered request on one span of each stage, on the thread of that
stage.
"""

import collections
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import registration as R
from repro_torch.data import synthetic as S
from repro_torch.serve import Request, ServeConfig, Server

SHAPE = (16, 16, 16)


@pytest.fixture(autouse=True)
def _fresh():
    obs.clear()
    yield
    obs.clear()


@pytest.fixture(scope="module")
def pair():
    return S.make_pair(0, SHAPE, device="cpu")


@pytest.fixture(scope="module")
def traced(pair):
    """A 16^3 registration under a CPU profiler session: the result, the
    spans and kineto's host events by name."""
    obs.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = R.register(pair.m0, pair.m1, device="cpu")
    spans = obs.spans()
    obs.clear()
    events = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        events[ev.name()].append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return res, spans, events


def _count(spans, name):
    return sum(s.name == name for s in spans)


def test_nothing_recorded_without_a_profiler_session(pair):
    assert not torch.autograd.profiler._is_profiler_enabled
    R.register(pair.m0, pair.m1, device="cpu", max_newton=1)
    assert obs.spans() == [] and obs.dropped() == 0
    # off, a span is one shared do-nothing object
    assert obs.span("a", x=1) is obs.span("b")


def test_registration_spans_count_its_work(traced):
    res, spans, _ = traced
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["register"]
    assert _count(spans, "gn.step") == len(res.history)
    assert _count(spans, "gn.gradient") == len(res.history)
    assert _count(spans, "gn.line_search") == len(res.history)
    assert _count(spans, "pcg.solve") == len(res.history)
    assert _count(spans, "pcg.matvec") == res.matvecs
    assert _count(spans, "register.h2d") == _count(spans, "register.score") == 1
    # every plan: per gradient two RK2 mid-point plans and two plans, per
    # line-search trial one of each, and one of each in scoring's warp and
    # in its det F
    trials = sum(h["ls_evals"] for h in res.history)
    assert _count(spans, "plan.build") == 4 * len(res.history) + 2 * trials + 4
    assert [s.attrs["step"] for s in spans if s.name == "gn.step"] == list(
        range(len(res.history)))


def test_host_syncs_are_the_reads(traced):
    """PCG tests its residual once more than it multiplies, the line search
    once per trial, the driver reads five numbers a step, scoring four."""
    res, spans, _ = traced
    by_id = {s.id: s for s in spans}

    def under(s, name):
        while s.parent is not None:
            s = by_id[s.parent]
            if s.name == name:
                return True
        return False

    syncs = [s for s in spans if s.name == "host.sync"]
    steps = len(res.history)
    assert sum(under(s, "pcg.solve") for s in syncs) == res.matvecs + steps
    assert sum(under(s, "gn.line_search") for s in syncs) == sum(
        h["ls_evals"] for h in res.history)
    assert sum(under(s, "register.score") for s in syncs) == 4
    assert len(syncs) == res.matvecs + steps + sum(
        h["ls_evals"] for h in res.history) + 5 * steps + 4


def test_children_lie_inside_their_parents(traced):
    _, spans, _ = traced
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.start_ns <= s.end_ns
        assert s.thread == threading.main_thread().name
        assert s.device_ms is None          # no CUDA here
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_stamps_on_kinetos_clock(traced):
    """Each span's stamps against kineto's ``record_function`` event of the
    same span (the n-th of its name, in start order) within 2 ms."""
    _, spans, events = traced
    seen = collections.Counter()
    worst = 0
    for s in sorted(spans, key=lambda s: s.start_ns):
        a, b = sorted(events[s.name])[seen[s.name]]
        seen[s.name] += 1
        worst = max(worst, abs(a - s.start_ns), abs(b - s.end_ns))
    assert worst <= 2_000_000


def test_sync_returns_the_value_read():
    x = torch.tensor([1.5, -2.0])
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs.sync(float, x[0]) == 1.5
        assert obs.sync(lambda t: t.tolist(), x) == [1.5, -2.0]
    assert obs.sync(bool, x[1] < 0) is True
    assert [s.name for s in obs.spans()] == ["host.sync", "host.sync"]


def test_threads_keep_their_own_stacks_and_the_cap_drops(monkeypatch):
    def work():
        with obs.span("outer"):
            with obs.span("inner", lane=1):
                pass

    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=work, name="worker")
        with obs.span("main"):
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
        obs.interval("wait", 1.0, 2.5, wave_id=3)
    spans = {s.name: s for s in obs.spans()}
    assert spans["inner"].parent == spans["outer"].id and spans["inner"].attrs == {"lane": 1}
    assert spans["outer"].parent is None and spans["outer"].thread == "worker"
    assert spans["main"].parent is None
    assert spans["wait"].end_ns - spans["wait"].start_ns == 1_500_000_000
    assert spans["wait"].attrs == {"wave_id": 3}

    monkeypatch.setattr(obs, "CAP", len(spans) + 1)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with obs.span("more"):
                pass
    assert len(obs.spans()) == len(spans) + 1 and obs.dropped() == 2
    obs.clear()
    assert obs.spans() == [] and obs.dropped() == 0


def test_server_stage_spans_carry_each_request(pair):
    cfg = ServeConfig(max_batch=2, max_wait_s=0.5, max_newton=2, warm_start=False,
                      device="cpu")
    pairs = [S.make_pair(seed, SHAPE, device="cpu") for seed in range(3)]
    with profile(activities=[ProfilerActivity.CPU]):
        with Server(cfg) as srv:
            futs = [srv.submit(Request(p.m0.numpy(), p.m1.numpy())) for p in pairs]
            ids = [f.result(timeout=600).request_id for f in futs]
    stages = {"serve.assemble": "serve-batcher", "serve.wave_wait": "serve-solver",
              "serve.h2d": "serve-solver", "serve.solve": "serve-solver",
              "serve.d2h": "serve-collector", "serve.collect": "serve-collector"}
    spans = [s for s in obs.spans() if s.name in stages]
    for s in spans:
        assert s.thread == stages[s.name]
        assert s.start_ns <= s.end_ns
    for rid in ids:
        mine = collections.Counter(s.name for s in spans if rid in s.attrs["request_ids"])
        assert mine == {name: 1 for name in stages}, rid
    by_wave = {(s.name, s.attrs["wave_id"]): s for s in spans}
    waves = {s.attrs["wave_id"] for s in spans}
    assert len(waves) == 2
    for w in waves:
        assert by_wave["serve.wave_wait", w].start_ns >= by_wave["serve.assemble", w].end_ns
        assert by_wave["serve.h2d", w].start_ns >= by_wave["serve.wave_wait", w].end_ns
        collect, d2h = by_wave["serve.collect", w], by_wave["serve.d2h", w]
        assert collect.start_ns <= d2h.start_ns and d2h.end_ns <= collect.end_ns
    # the lanes' Newton steps ran on the solver thread
    lanes = [s for s in obs.spans() if s.name == "gn.step"]
    assert lanes and all(s.thread == "serve-solver" and "lane" in s.attrs for s in lanes)

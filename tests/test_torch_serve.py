"""The port's live registration server (``repro_torch.serve.Server`` on the
CPU) against the JAX package's (``repro.serve.Server``), request by request.

The configuration is ``tests/test_serve.py``'s: ``max_batch=2``,
``max_wait_s=0.2``, ``nt=2``, ``max_newton=6``, ``tol_rel_grad=0.3``,
fd8-linear, 12^3 and 16^3 pairs of JAX's ``synthetic.make_pair`` (handed
over as numpy), a checkpointed cache with synchronous IO. Both servers take
the same requests in the same rounds, each round waited on:

1. a mixed-grid round: two 12^3 subjects and one 16^3 subject;
2. two 12^3 subjects, cold;
3. the same two again: warm starts from the cache;
4. a follow-up of a round-1 subject on 16^3: a cross-grid warm start;
5. round 2's first pair alone, with no subject: a padded partial wave.

Per request: equal ``iters``, ``matvecs``, ``converged``, ``warm_started``,
``cache_visits``, ``wave_real`` and ``wave_padded``; ``v`` within
1e-4 * max|v| (the batch tests' tolerance against JAX) and ``mismatch_rel``
within rtol 1e-4. Then the JAX test's own claims on the port's server
(grids never share a wave, warm solves take strictly fewer iterations, the
summary counts, a submit before ``start()`` and ``max_batch=0`` raise), the
device contract (``ServeConfig()`` is on ``cuda`` and raises without a
card), and the launcher's smoke run on the CPU.

JAX's server runs once for the module (its compiles take ~35 s here), the
port's with torch on one intra-op thread: beside the other test workers,
threads on every core make its small ops wait on each other.
"""

import numpy as np
import pytest
import torch

import jax

from repro import serve as jserve
from repro.data import synthetic as jsyn
from repro_torch.checkpoint import latest_step
from repro_torch.launch import serve_registration as SR
from repro_torch.serve import Request, ServeConfig, Server

VARIANT = "fd8-linear"
GRID_A = (12, 12, 12)
GRID_B = (16, 16, 16)
CFG = dict(max_batch=2, max_wait_s=0.2, nt=2, max_newton=6, tol_rel_grad=0.3,
           cache_async_io=False)
V_REL = 1e-4
MISMATCH_RTOL = 1e-4
TIMEOUT = 900


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(seed, grid):
    p = jsyn.make_pair(jax.random.PRNGKey(seed), grid, amplitude=0.5)
    return np.asarray(p.m0), np.asarray(p.m1)


def _rounds():
    pa, pb, pc = _pair(0, GRID_A), _pair(1, GRID_A), _pair(2, GRID_B)
    w1, w2 = _pair(3, GRID_A), _pair(4, GRID_A)
    follow = _pair(5, GRID_B)
    warm = [(w1, "warm-1"), (w2, "warm-2")]
    return [
        [(pa, "mix-a"), (pb, "mix-b"), (pc, "mix-c")],
        warm,
        warm,
        [(follow, "mix-a")],
        [(w1, None)],
    ]


def _serve(server_cls, request_cls, config):
    """Every round through one server; per round the results in submission
    order, and the summary."""
    out = []
    with server_cls(config) as srv:
        for rnd in _rounds():
            futs = [srv.submit(request_cls(m0=p[0], m1=p[1], subject=s, variant=VARIANT))
                    for p, s in rnd]
            out.append([f.result(timeout=TIMEOUT) for f in futs])
        summary = srv.summary()
    return out, summary


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jdir = tmp_path_factory.mktemp("jax_cache")
    tdir = tmp_path_factory.mktemp("port_cache")
    ref = _serve(jserve.Server, jserve.Request,
                 jserve.ServeConfig(cache_dir=str(jdir), **CFG))
    got = _serve(Server, Request, ServeConfig(cache_dir=str(tdir), device="cpu", **CFG))
    return got, ref, tdir


_INDEX = [(r, i) for r, n in enumerate([3, 2, 2, 1, 1]) for i in range(n)]


@pytest.mark.parametrize("r,i", _INDEX, ids=[f"round{r + 1}-{i}" for r, i in _INDEX])
def test_request_matches_jax_server(served, r, i):
    (got, _), (ref, _), _ = served
    a, b = got[r][i], ref[r][i]
    for field in ("grid", "subject", "iters", "matvecs", "converged", "warm_started",
                  "cache_visits", "wave_real", "wave_padded"):
        assert getattr(a, field) == getattr(b, field), field
    vb = np.asarray(b.v)
    assert isinstance(a.v, np.ndarray) and a.v.shape == vb.shape == (3,) + a.grid
    dv = float(np.max(np.abs(a.v - vb)))
    assert dv <= V_REL * float(np.max(np.abs(vb))), dv
    np.testing.assert_allclose(a.mismatch_rel, b.mismatch_rel, rtol=MISMATCH_RTOL)
    np.testing.assert_allclose(a.gnorm0, b.gnorm0, rtol=1e-4)


def test_server_mixed_grid_stream(served):
    (got, _), _, _ = served
    results = got[0]
    assert [r.grid for r in results] == [GRID_A, GRID_A, GRID_B]
    for r in results:
        assert r.v.shape == (3,) + r.grid
        assert np.isfinite(r.mismatch_rel) and r.mismatch_rel < 1.0
        assert r.iters >= 1 and r.matvecs >= 1
        assert not r.warm_started
        assert 1 <= r.wave_real <= r.wave_padded == 2
        assert r.latency_s >= r.queue_s >= 0.0
    # grids never share a wave
    assert results[2].wave_id not in {r.wave_id for r in results[:2]}


def test_server_repeat_subject_warm_starts(served):
    (got, _), _, cache_dir = served
    cold = {r.subject: r for r in got[1]}
    warm = {r.subject: r for r in got[2]}
    for subj in ("warm-1", "warm-2"):
        c, w = cold[subj], warm[subj]
        assert not c.warm_started and c.iters >= 1
        assert w.warm_started and w.cache_visits == 1
        # judged against the *cold* gradient reference ...
        assert w.gnorm0 == pytest.approx(c.gnorm0, rel=1e-5)
        # ... and on an identical follow-up, strictly fewer Newton steps
        assert w.iters < c.iters
        assert w.converged
        assert w.mismatch_rel <= c.mismatch_rel + 1e-6
    assert latest_step(str(cache_dir / "warm-1")) == 2


def test_server_cross_grid_and_partial_wave(served):
    (got, _), _, cache_dir = served
    follow = got[3][0]
    assert follow.warm_started and follow.cache_visits == 1 and follow.grid == GRID_B
    assert latest_step(str(cache_dir / "mix-a")) == 2
    part, cold = got[4][0], got[1][0]
    assert (part.wave_real, part.wave_padded) == (1, 2)
    assert not part.warm_started and part.subject is None
    assert (part.iters, part.matvecs) == (cold.iters, cold.matvecs)
    np.testing.assert_array_equal(part.v, cold.v)


def test_server_summary_counts(served):
    (_, s), (_, s_ref), _ = served
    assert s["submitted"] == s["completed"] == 9
    assert s["failed"] == 0
    assert s["warm_hits"] == 3
    assert s["waves"] == 6
    assert s["latency_p50_s"] > 0 and s["latency_p99_s"] >= s["latency_p50_s"]
    assert s["iters_mean_warm"] < s["iters_mean_cold"]
    assert s["utilization_mean"] == pytest.approx(4.5 / 6)
    for k in ("submitted", "completed", "failed", "warm_hits", "waves", "utilization_mean",
              "wave_real_mean", "iters_mean_warm", "iters_mean_cold"):
        assert s[k] == s_ref[k], k


def test_server_rejects_submit_before_start():
    srv = Server(ServeConfig(max_batch=1, device="cpu"))
    m = np.zeros(GRID_A, np.float32)
    with pytest.raises(RuntimeError):
        srv.submit(Request(m0=m, m1=m))


def test_serve_config_validation():
    with pytest.raises(ValueError):
        ServeConfig(max_batch=0)
    with pytest.raises(ValueError, match="halo_compression"):
        ServeConfig(halo_compression="fp8")
    with pytest.raises(ValueError, match="no ensemble group"):
        ServeConfig(mesh=object())


def test_server_defaults_to_cuda_and_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ServeConfig().device == "cuda"
    srv = Server()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srv.start()
    m = np.zeros(GRID_A, np.float32)
    with pytest.raises(RuntimeError, match="not started"):
        srv.submit(Request(m0=m, m1=m))


def test_launcher_smoke_on_cpu(capsys):
    assert SR.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "completed 6/6" in out


def test_launcher_raises_on_cuda_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SR.main(["--smoke"])


def test_synthetic_study_drifts_revisits():
    reqs = SR.synthetic_study([GRID_A], n_requests=3, n_subjects=2, seed=1, device="cpu")
    assert [r.subject for r in reqs] == ["subject-000", "subject-001", "subject-000"]
    assert torch.equal(reqs[0].m0, reqs[2].m0)
    assert not torch.equal(reqs[0].m1, reqs[2].m1)
    again = SR.synthetic_study([GRID_A], n_requests=1, n_subjects=1, seed=1, device="cpu")
    assert torch.equal(again[0].m1, reqs[0].m1)
    assert SR.poisson_delays(3, 0.0) == [0.0, 0.0, 0.0]
    d = SR.poisson_delays(4, 2.0, seed=3)
    assert all(b > a for a, b in zip(d, d[1:]))

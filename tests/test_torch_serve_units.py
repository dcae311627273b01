"""The host-side units of the port's registration server
(``repro_torch.serve``) against the JAX package's (``repro.serve``).

* ``Request`` validation: the cases of ``tests/test_serve.py``, plus
  tensors and the measure.
* One ``put`` sequence through JAX's and the port's ``RequestQueue``: equal
  waves (oldest head first, FIFO within a bucket, never two buckets in one
  wave).
* ``percentile`` and ``ServeStats.summary`` equal to JAX's on seeded
  samples.
* ``WarmStartCache`` in memory, on disk, across grids and with ``keep``
  GC; the cross-grid ``v0`` within 1e-5 of JAX's cache on the same random
  field; a cache directory written by JAX's cache is read by the port's,
  and the reverse, bit for bit.

No Newton step is compiled here.
"""

import json

import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.serve.batching import PendingRequest as JPending
from repro_torch.checkpoint import latest_step
from repro_torch.serve import (BucketKey, Request, RequestQueue, RequestResult,
                               ServeStats, WarmStartCache, percentile)
from repro_torch.serve.batching import PendingRequest

VARIANT = "fd8-linear"
GRID_A = (12, 12, 12)
GRID_B = (16, 16, 16)
CROSS_GRID_ATOL = 1e-5


def test_request_validation():
    m = np.zeros(GRID_A, np.float32)
    r = Request(m0=m, m1=m, subject="s")
    assert r.grid == GRID_A
    with pytest.raises(ValueError):
        Request(m0=m, m1=np.zeros((8, 8, 9), np.float32))
    with pytest.raises(ValueError):
        Request(m0=np.zeros((2,) + GRID_A, np.float32),
                m1=np.zeros((2,) + GRID_A, np.float32))
    with pytest.raises(ValueError):
        Request(m0=m, m1=m, variant="no-such-variant")


def test_request_takes_tensors_and_checks_the_measure():
    t = torch.zeros(GRID_A)
    assert Request(m0=t, m1=np.zeros(GRID_A, np.float32)).grid == GRID_A
    assert Request(m0=t, m1=t, measure="ncc").measure == "ncc"
    with pytest.raises(ValueError, match="shapes differ"):
        Request(m0=t, m1=torch.zeros(GRID_B))
    with pytest.raises(ValueError, match="shapes differ"):
        Request(m0=[0.0], m1=[0.0])
    with pytest.raises(ValueError, match="string"):
        Request(m0=t, m1=t, measure=None)
    with pytest.raises(ValueError, match="unknown distance measure"):
        Request(m0=t, m1=t, measure="mutual-information")


def test_request_result_to_dict_is_json_safe():
    rr = RequestResult(request_id=3, subject="s", variant=VARIANT, grid=GRID_A,
                       v=np.zeros((3,) + GRID_A, np.float32), mismatch_rel=0.25, iters=2,
                       matvecs=5, gnorm0=1.5, rel_grad=0.1, converged=True,
                       warm_started=False)
    d = rr.to_dict()
    assert d["v"] == [3, 12, 12, 12] and d["grid"] == [12, 12, 12]
    assert json.loads(json.dumps(d))["matvecs"] == 5


#: (grid, variant, measure, t_submit) of one put sequence: three buckets by
#: grid, variant and measure, heads of different ages, all windows closed.
PUTS = [(GRID_A, VARIANT, "ssd", 0.0), (GRID_B, VARIANT, "ssd", 1.0),
        (GRID_A, VARIANT, "ssd", 2.0), (GRID_A, "fd8-cubic", "ssd", 2.5),
        (GRID_A, VARIANT, "ncc", 2.7), (GRID_A, VARIANT, "ssd", 3.0),
        (GRID_B, VARIANT, "ssd", 4.0), (GRID_A, VARIANT, "ssd", 5.0)]


def _waves(queue, pending_cls, request_cls, max_batch):
    for rid, (grid, variant, measure, t) in enumerate(PUTS):
        m = np.zeros(grid, np.float32)
        queue.put(pending_cls(request_id=rid, request=request_cls(
            m0=m, m1=m, variant=variant, measure=measure), future=None, t_submit=t))
    waves = []
    while True:
        w = queue.next_wave(max_batch=max_batch, max_wait_s=0.0, poll_s=0.01)
        if w is None:
            break
        waves.append(([p.request_id for p in w], tuple(w[0].key)))
        assert len({p.key for p in w}) == 1
    queue.close()
    assert queue.next_wave(max_batch, 0.0) is None and queue.drained
    return waves


@pytest.mark.parametrize("max_batch", [1, 2, 3])
def test_queue_forms_the_jax_waves(max_batch):
    got = _waves(RequestQueue(), PendingRequest, Request, max_batch)
    ref = _waves(jserve.RequestQueue(), JPending, jserve.Request, max_batch)
    assert got == ref
    assert sorted(i for ids, _ in got for i in ids) == list(range(len(PUTS)))
    if max_batch == 2:
        assert got[0] == ([0, 2], tuple(BucketKey(GRID_A, VARIANT, "ssd")))


def test_queue_depth_and_key():
    q = RequestQueue()
    for i in range(5):
        m = np.zeros(GRID_A, np.float32)
        q.put(PendingRequest(request_id=i, request=Request(m0=m, m1=m, variant=VARIANT),
                             future=None, t_submit=float(i)))
    w = q.next_wave(max_batch=3, max_wait_s=0.0)
    assert [p.request_id for p in w] == [0, 1, 2]
    assert q.depth() == 2
    assert w[0].key == BucketKey(grid=GRID_A, variant=VARIANT)
    q.close()
    with pytest.raises(RuntimeError, match="closed"):
        q.put(w[0])


@pytest.mark.parametrize("n", [0, 1, 2, 7, 100])
def test_percentile_equals_jax(n):
    xs = np.random.default_rng(n).exponential(size=n).tolist()
    for q in (0, 1, 37.5, 50, 90, 99, 100):
        assert percentile(xs, q) == jserve.percentile(xs, q)


def _feed(stats, rng):
    for i in range(12):
        stats.record_submit(float(i) * 0.1)
    for i in range(10):
        warm = bool(i % 3 == 0)
        rec = dict(request_id=i, warm_started=warm, iters=int(rng.integers(1, 6)),
                   latency_s=float(rng.exponential()), queue_s=float(rng.exponential()),
                   solve_s=float(rng.exponential()))
        stats.record_request(rec, t_done=2.0 + i * 0.25)
    stats.record_failure(2)
    for w in range(4):
        real = int(rng.integers(1, 5))
        stats.record_wave(dict(wave_id=w, real=real, padded=4, utilization=real / 4))


def test_serve_stats_summary_equals_jax():
    got, ref = ServeStats(), jserve.ServeStats()
    _feed(got, np.random.default_rng(7))
    _feed(ref, np.random.default_rng(7))
    assert got.summary() == ref.summary()
    assert ServeStats().summary() == jserve.ServeStats().summary()


# ---------------------------------------------------------------------------
# warm-start cache over repro_torch.checkpoint
# ---------------------------------------------------------------------------


def test_warm_cache_memory_and_disk(tmp_path):
    d = str(tmp_path / "cache")
    cache = WarmStartCache(d, keep=2, async_io=False)
    v1 = np.full((3,) + GRID_A, 0.5, np.float32)
    assert cache.lookup("subj", GRID_A) is None
    assert cache.update("subj", v1, gnorm0=10.0, grid=GRID_A) == 1
    ws = cache.lookup("subj", GRID_A)
    assert ws.visits == 1 and ws.gnorm_ref == 10.0
    np.testing.assert_allclose(ws.v0, v1)

    # revisit: velocity replaced, the *cold* gnorm reference is kept
    assert cache.update("subj", torch.from_numpy(2 * v1), gnorm0=0.01, grid=GRID_A) == 2
    ws = cache.lookup("subj", GRID_A)
    assert ws.visits == 2 and ws.gnorm_ref == 10.0
    assert isinstance(ws.v0, np.ndarray)
    np.testing.assert_allclose(ws.v0, 2 * v1)

    # a fresh cache (fresh server process) restores the latest visit from disk
    fresh = WarmStartCache(d, async_io=False)
    ws = fresh.lookup("subj", GRID_A)
    assert ws is not None and ws.visits == 2 and ws.gnorm_ref == 10.0
    np.testing.assert_allclose(ws.v0, 2 * v1)

    # cross-grid follow-up: the cached velocity is spectrally resampled;
    # constant fields survive the Fourier transfer exactly
    ws_up = fresh.lookup("subj", GRID_B)
    assert ws_up.v0.shape == (3,) + GRID_B
    np.testing.assert_allclose(ws_up.v0, np.full((3,) + GRID_B, 1.0), atol=CROSS_GRID_ATOL)

    # keep=2 GC: a third visit drops the first step directory
    cache.update("subj", v1, gnorm0=0.02, grid=GRID_A)
    subj_dir = next(p for p in (tmp_path / "cache").iterdir())
    steps = sorted(p.name for p in subj_dir.iterdir() if p.name.startswith("step_"))
    assert steps == ["step_00000002", "step_00000003"]


def test_warm_cache_update_copies_a_tensor():
    cache = WarmStartCache(None)
    v = torch.ones((3,) + GRID_A)
    cache.update("s", v, gnorm0=1.0, grid=GRID_A)
    v.fill_(-1.0)   # a later in-place solve step
    np.testing.assert_array_equal(cache.lookup("s", GRID_A).v0, 1.0)


def test_warm_cache_async_io_flushes(tmp_path):
    cache = WarmStartCache(str(tmp_path), keep=3)
    v = np.random.default_rng(0).normal(size=(3,) + GRID_A).astype(np.float32)
    for visit in range(1, 5):
        cache.update("a/b", v * visit, gnorm0=3.0, grid=GRID_A)
    cache.flush()
    assert latest_step(str(tmp_path / "a_b")) == 4
    np.testing.assert_array_equal(WarmStartCache(str(tmp_path)).lookup("a/b", GRID_A).v0,
                                  4 * v)


def test_warm_cache_unknown_subject_and_none():
    cache = WarmStartCache(None)
    assert cache.lookup(None, GRID_A) is None
    assert cache.lookup("nobody", GRID_A) is None
    assert cache.update(None, np.zeros((3,) + GRID_A), 1.0, GRID_A) == 0
    assert len(cache) == 0


@pytest.mark.parametrize("grid_to", [GRID_B, (8, 8, 8), (12, 16, 10)])
def test_cross_grid_v0_matches_jax(grid_to):
    v = np.random.default_rng(1).normal(size=(3,) + GRID_A).astype(np.float32)
    got, ref = WarmStartCache(None), jserve.WarmStartCache(None)
    got.update("s", v, gnorm0=2.0, grid=GRID_A)
    ref.update("s", v, gnorm0=2.0, grid=GRID_A)
    a, b = got.lookup("s", grid_to), ref.lookup("s", grid_to)
    assert a.v0.shape == (3,) + grid_to and a.v0.dtype == np.float32
    np.testing.assert_allclose(a.v0, np.asarray(b.v0), rtol=0, atol=CROSS_GRID_ATOL)
    assert (a.gnorm_ref, a.visits) == (b.gnorm_ref, b.visits)


def _write_visits(cache, v):
    cache.update("patient-7", v, gnorm0=4.5, grid=GRID_A)
    cache.update("patient-7", 2 * v, gnorm0=0.3, grid=GRID_A)
    cache.update("other", v[:, :8, :8, :8].copy(), gnorm0=1.25, grid=(8, 8, 8))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_directory_read_across_packages(tmp_path, writer):
    v = np.random.default_rng(2).normal(size=(3,) + GRID_A).astype(np.float32)
    caches = {"jax": jserve.WarmStartCache, "port": WarmStartCache}
    _write_visits(caches[writer](str(tmp_path), async_io=False), v)
    reader = caches["port" if writer == "jax" else "jax"](str(tmp_path))
    ws = reader.lookup("patient-7", GRID_A)
    assert ws.visits == 2 and ws.gnorm_ref == 4.5
    np.testing.assert_array_equal(np.asarray(ws.v0), 2 * v)
    ws = reader.lookup("other", (8, 8, 8))
    assert ws.visits == 1 and ws.gnorm_ref == 1.25
    np.testing.assert_array_equal(np.asarray(ws.v0), v[:, :8, :8, :8])

"""Registration-as-a-service: the batched solve server (port of
``repro.serve.server``).

Pipeline (three threads, two depth-1 hand-off queues — the double buffer):

    submit() ──► RequestQueue ──► [batcher] ──► wave queue ──► [solver]
                 (bucketed by      forms waves,  (depth 1)      moves the
                  grid, variant,   stacks host                  wave to the
                  measure)         arrays, looks                device, runs
                                   up warm starts               the batched /
                                        │                       slab solve
    futures ◄── [collector] ◄── collect queue (depth 1) ◄───────┘
                copies results to the host, updates the warm-start cache
                (async checkpoint saves), resolves futures

While wave *k* occupies the device, the batcher is already stacking wave
*k+1* on the host and the collector is materializing wave *k-1*. Only the
solver thread launches kernels. The solver and the collector share the
device's default stream, so the collector's copy of wave *k-1* waits for the
kernels queued before it; ``solve_batch`` synchronises every Newton step,
so that is at most one step of the next wave.

Waves are padded to a fixed width (``max_batch``, repeating the first pair
from a cold start) as in the JAX server; padded lanes are dropped at
collection. The port's batched step runs the lanes of a wave one after
another, so a padded lane costs a whole solve (the real lanes' results do
not depend on it). Each bucket's batch step is the donating one
(``gauss_newton._make_batch_step(donate=True)``): the stopping test runs on
the device and the wave's velocity is updated in place. Every wave gets its
own device velocity, copied from the host ``v0``; what the collector, the
cache and the checkpoints keep are host copies.

Warm starts: requests tagged with a ``subject`` that the
:class:`~repro_torch.serve.cache.WarmStartCache` knows start from the prior
visit's velocity, with the *cold* initial gradient norm as the per-pair
stopping reference (``gnorm_ref``).

Mesh mode (``ServeConfig(mesh=...)``, an ensemble x slab layout from
``repro_torch.distributed.group.ensemble_slab_groups``): every rank of the
world group runs ``claire_dist.solve_ensemble_slab`` on the same global
wave, SPMD, where the JAX server solves it from one controller. Rank 0 hosts
the :class:`Server`; its solver thread hands each wave (the bucket key, the
images, ``v0`` and ``gnorm_ref``) to the other ranks over the world group
and then solves its share. The other ranks run :func:`run_slab_worker`,
which receives waves and solves in step with rank 0 until ``stop()`` sends
the stop marker. Every rank ends with the gathered velocities; rank 0 alone
scores them and resolves the futures.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
import traceback
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import device as _device
from .. import obs
from ..core import gauss_newton as _gn
from ..core import metrics as _metrics
from ..core import registration as _reg
from ..distributed import claire_dist as _dist
from ..distributed import group as _group
from .batching import BucketKey, PendingRequest, RequestQueue
from .cache import WarmStartCache
from .metrics import ServeStats
from .request import Request, RequestResult

_SENTINEL = object()


@dataclass(frozen=True)
class ServeConfig:
    """Server-level solver + batching knobs (per-request: variant, measure,
    subject). The JAX server's fields and defaults, with ``device`` in place
    of ``backend``; ``mesh`` is an ``EnsembleSlabGroups`` layout, whose
    groups take the place of the JAX mesh's axis names."""

    # dynamic batching
    max_batch: int = 4            # wave width (padding target)
    max_wait_s: float = 0.05      # batching window of a wave's head request
    pad_waves: bool = True        # pad partial waves to max_batch
    # solver (Gauss-Newton / transport) configuration shared by all buckets
    nt: int = 4
    beta: float = 5e-4
    gamma: float = 1e-4
    tol_rel_grad: float = 5e-2
    max_newton: int = 20
    mixed_precision: bool = False
    use_plan: bool = True
    use_fused_matvec: bool = False
    # warm-start cache
    warm_start: bool = True
    cache_dir: Optional[str] = None   # persist per-subject velocities
    cache_keep: int = 3               # checkpoint GC: visits kept per subject
    cache_async_io: bool = True
    # slab-distributed waves: solve each wave with solve_ensemble_slab on
    # this layout of ranks instead of the single-device batched step.
    mesh: object = None
    halo: int = 6
    halo_compression: str = "none"
    # the device the solves run on: the card unless the caller asks for the
    # CPU; start() raises when the card is asked for and absent.
    device: str = "cuda"

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.halo_compression not in ("none", "int8"):
            raise ValueError("halo_compression must be 'none' or 'int8', "
                             f"got {self.halo_compression!r}")
        if self.mesh is not None:
            if not isinstance(self.mesh, _group.EnsembleSlabGroups):
                raise ValueError(
                    f"mesh {self.mesh!r} has no ensemble group; pass "
                    "repro_torch.distributed.group.ensemble_slab_groups(E, S)")
            if not self.pad_waves:
                raise ValueError("mesh serving requires pad_waves=True "
                                 "(fixed wave width)")
            if self.max_batch % self.mesh.ensemble_size != 0:
                raise ValueError(
                    f"max_batch {self.max_batch} not divisible by the "
                    f"ensemble group's {self.mesh.ensemble_size} ranks")


class _AssembledWave(NamedTuple):
    wave_id: int
    key: BucketKey
    pendings: List[PendingRequest]
    m0: np.ndarray                # (P, N1, N2, N3), P = padded width
    m1: np.ndarray
    v0: np.ndarray                # (P, 3, N1, N2, N3)
    gnorm_ref: np.ndarray         # (P,), NaN = cold (observed reference)
    warm: List[bool]
    visits: List[int]
    request_ids: tuple            # the real lanes' requests, for the spans
    t_dispatch: float             # assembly done; the wave waits from here
    assemble_s: float


class _SolvedWave(NamedTuple):
    wave: _AssembledWave
    result: _gn.BatchGNResult     # result.v on the device, (P, 3, N...)
    mismatch: torch.Tensor        # (P,) on the device
    solve_s: float


def _pinned_device(device) -> torch.device:
    """``device`` resolved, with the card's index fixed to the caller's
    current card: the server's threads start on card 0 whatever the caller
    set (the current card is a per-thread setting)."""
    dev = _device.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _transport_cfg(config: ServeConfig, key: BucketKey):
    return _reg.make_transport_config(
        key.variant, nt=config.nt, mixed_precision=config.mixed_precision,
        use_plan=config.use_plan, measure=key.measure,
        use_fused_matvec=config.use_fused_matvec)


def _gn_cfg(config: ServeConfig) -> _gn.GNConfig:
    return _gn.GNConfig(beta=config.beta, gamma=config.gamma,
                        tol_rel_grad=config.tol_rel_grad,
                        max_newton=config.max_newton)


def _score(m0: torch.Tensor, m1: torch.Tensor, v: torch.Tensor, cfg) -> torch.Tensor:
    """The server's mismatch of every lane, ``||m0(y) - m1|| / ||m1 - m0||``,
    and 0 for an identical pair (already matched), as the JAX server's
    scorer; ``registration._score_batch`` also computes det F."""
    out = []
    for b in range(m0.shape[0]):
        warped = _metrics.warp_image(m0[b], v[b], cfg)
        num = torch.sqrt(torch.sum((warped - m1[b]) ** 2))
        den = torch.sqrt(torch.sum((m1[b] - m0[b]) ** 2))
        out.append(torch.where(den > 0, num / torch.clamp(den, min=1e-30), 0.0))
    return torch.stack(out)


# -- mesh mode: the wave hand-off from rank 0 over the world group ----------


def _slab_solve(config: ServeConfig, gn: _gn.GNConfig, key: BucketKey, m0, m1, v0,
                gnorm_ref) -> _gn.BatchGNResult:
    return _dist.solve_ensemble_slab(
        m0, m1, _transport_cfg(config, key), gn, groups=config.mesh, halo=config.halo,
        compress=config.halo_compression, v0=v0, gnorm_ref=gnorm_ref)


def _send_wave(key: BucketKey, m0, m1, v0, gnorm_ref) -> None:
    dist.broadcast_object_list([(key, tuple(m0.shape), gnorm_ref)], src=0)
    for t in (m0, m1, v0):
        dist.broadcast(t, src=0)


def _send_stop() -> None:
    dist.broadcast_object_list([None], src=0)


def _recv_wave(dev: torch.device):
    """The next wave from rank 0, ``(key, m0, m1, v0, gnorm_ref)``, or None
    at the stop marker."""
    head = [None]
    dist.broadcast_object_list(head, src=0)
    if head[0] is None:
        return None
    key, shape, gnorm_ref = head[0]
    m0 = torch.empty(shape, dtype=torch.float32, device=dev)
    m1 = torch.empty_like(m0)
    v0 = torch.empty((shape[0], 3) + tuple(shape[1:]), dtype=torch.float32, device=dev)
    for t in (m0, m1, v0):
        dist.broadcast(t, src=0)
    return key, m0, m1, v0, gnorm_ref


def run_slab_worker(config: ServeConfig) -> int:
    """The loop of a rank other than 0 in the mesh mode: receive each wave
    that rank 0's server hands out and solve it in step with rank 0, until
    the stop marker of ``Server.stop()``. Called on every rank but 0, with
    the config rank 0's server runs; returns the number of waves received.
    A wave whose solve raises is skipped (rank 0 meets the same error on
    the same wave, fails its requests and goes on)."""
    if config.mesh is None:
        raise ValueError("run_slab_worker serves the mesh mode: config.mesh is None")
    dev = _pinned_device(config.device)
    _reg._check_slab_group(config.mesh.slab, dev)
    if dist.get_rank() == 0:
        raise ValueError("rank 0 hosts the Server; run_slab_worker runs on the others")
    gn = _gn_cfg(config)
    waves = 0
    while True:
        wave = _recv_wave(dev)
        if wave is None:
            return waves
        waves += 1
        try:
            _slab_solve(config, gn, *wave)
        except Exception:
            traceback.print_exc()


class Server:
    """Sync in-process serving API; see module docstring for the pipeline.

        with Server(ServeConfig(max_batch=4)) as server:
            fut = server.submit(Request(m0, m1, subject="patient-7"))
            result = fut.result()

    ``submit`` returns a ``concurrent.futures.Future`` (asyncio front ends
    wrap it with ``asyncio.wrap_future``; see
    ``repro_torch.launch.serve_registration``).
    """

    def __init__(self, config: ServeConfig = ServeConfig()):
        self.config = config
        self.stats = ServeStats()
        self.cache = WarmStartCache(
            config.cache_dir, keep=config.cache_keep,
            async_io=config.cache_async_io) if config.warm_start else None
        self._queue = RequestQueue()
        self._wave_q: "queue.Queue" = queue.Queue(maxsize=1)
        self._collect_q: "queue.Queue" = queue.Queue(maxsize=1)
        self._ids = itertools.count()
        self._wave_ids = itertools.count()
        self._steps: Dict = {}        # BucketKey -> donating batch step
        self._gn = _gn_cfg(config)
        self._dev: Optional[torch.device] = None
        self._threads: List[threading.Thread] = []
        self._started = False
        self._stopping = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Server":
        if self._started:
            return self
        self._dev = _pinned_device(self.config.device)
        if self.config.mesh is not None:
            _reg._check_slab_group(self.config.mesh.slab, self._dev)
            if dist.get_rank() != 0:
                raise ValueError("in the mesh mode rank 0 hosts the Server; the "
                                 "other ranks run run_slab_worker(config)")
        self._started = True
        for name, fn in (("serve-batcher", self._batcher_loop),
                         ("serve-solver", self._solver_loop),
                         ("serve-collector", self._collector_loop)):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        """Close ingest, drain queued work, join the pipeline, flush cache
        (and, in the mesh mode, release the other ranks' worker loops)."""
        if not self._started or self._stopping:
            return
        self._stopping = True
        self._queue.close()
        for t in self._threads:
            t.join()
        self._threads = []
        if self.cache is not None:
            self.cache.flush()
        self._started = False
        self._stopping = False

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client API --------------------------------------------------------

    def submit(self, request: Request) -> Future:
        if not self._started:
            raise RuntimeError("server not started (use start() or a with-block)")
        fut: Future = Future()
        pending = PendingRequest(
            request_id=next(self._ids), request=request, future=fut,
            t_submit=time.perf_counter())
        self._queue.put(pending)
        self.stats.record_submit(pending.t_submit)
        return fut

    def solve(self, request: Request, timeout: Optional[float] = None
              ) -> RequestResult:
        """Blocking convenience: submit and wait."""
        return self.submit(request).result(timeout=timeout)

    def summary(self) -> Dict:
        return self.stats.summary()

    # -- pipeline stage 1: batcher (host assembly) --------------------------

    def _batcher_loop(self):
        c = self.config
        while True:
            wave = self._queue.next_wave(c.max_batch, c.max_wait_s)
            if not wave:
                if self._queue.drained:
                    self._wave_q.put(_SENTINEL)
                    return
                continue
            try:
                assembled = self._assemble(wave)
            except Exception as e:  # malformed inputs must not kill the loop
                for p in wave:
                    p.future.set_exception(e)
                self.stats.record_failure(len(wave))
                continue
            self._wave_q.put(assembled)

    def _assemble(self, wave: List[PendingRequest]) -> _AssembledWave:
        t0 = time.perf_counter()
        c = self.config
        key = wave[0].key
        real = len(wave)
        padded = c.max_batch if c.pad_waves else real
        grid = key.grid

        m0 = np.empty((padded,) + grid, np.float32)
        m1 = np.empty((padded,) + grid, np.float32)
        v0 = np.zeros((padded, 3) + grid, np.float32)
        refs = np.full((padded,), np.nan, np.float64)
        warm: List[bool] = []
        visits: List[int] = []
        for i, p in enumerate(wave):
            m0[i] = _host_array(p.request.m0)
            m1[i] = _host_array(p.request.m1)
            ws = (self.cache.lookup(p.request.subject, grid)
                  if self.cache is not None else None)
            if ws is not None:
                v0[i] = ws.v0
                refs[i] = ws.gnorm_ref
                warm.append(True)
                visits.append(ws.visits)
            else:
                warm.append(False)
                visits.append(0)
        # Padding lanes repeat pair 0 from a cold start; their solves keep
        # the wave shape fixed and are dropped at collection.
        for i in range(real, padded):
            m0[i] = m0[0]
            m1[i] = m1[0]
        wave_id = next(self._wave_ids)
        request_ids = tuple(p.request_id for p in wave)
        t1 = time.perf_counter()
        obs.interval("serve.assemble", t0, t1, wave_id=wave_id, request_ids=request_ids)
        return _AssembledWave(
            wave_id=wave_id, key=key, pendings=wave,
            m0=m0, m1=m1, v0=v0, gnorm_ref=refs, warm=warm, visits=visits,
            request_ids=request_ids, t_dispatch=t1, assemble_s=t1 - t0)

    # -- pipeline stage 2: solver (device) ----------------------------------

    def _step_for(self, key: BucketKey):
        step = self._steps.get(key)
        if step is None:
            step = _gn._make_batch_step(_transport_cfg(self.config, key), self._gn,
                                        donate=True)
            self._steps[key] = step
        return step

    def _solver_loop(self):
        c = self.config
        dev = self._dev
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        while True:
            item = self._wave_q.get()
            t0 = time.perf_counter()
            if item is _SENTINEL:
                if c.mesh is not None:
                    _send_stop()
                self._collect_q.put(_SENTINEL)
                return
            wave: _AssembledWave = item
            tags = dict(wave_id=wave.wave_id, request_ids=wave.request_ids)
            obs.interval("serve.wave_wait", wave.t_dispatch, t0, **tags)
            try:
                cfg_t = _transport_cfg(c, wave.key)
                m0 = torch.from_numpy(wave.m0).to(dev)
                m1 = torch.from_numpy(wave.m1).to(dev)
                # the wave's own velocity: the donating step writes it
                v0 = torch.from_numpy(wave.v0).to(dev, copy=True)
                t1 = time.perf_counter()
                obs.interval("serve.h2d", t0, t1, **tags)
                if c.mesh is not None:
                    _send_wave(wave.key, m0, m1, v0, wave.gnorm_ref)
                    res = _slab_solve(c, self._gn, wave.key, m0, m1, v0, wave.gnorm_ref)
                else:
                    res = _gn.solve_batch(
                        m0, m1, cfg_t, self._gn, v0=v0, gnorm_ref=wave.gnorm_ref,
                        step_fn=self._step_for(wave.key), donate=True)
                mismatch = _score(m0, m1, res.v, cfg_t)
                t2 = time.perf_counter()
                obs.interval("serve.solve", t1, t2, **tags)
                solve_s = t2 - t0
            except Exception as e:
                for p in wave.pendings:
                    p.future.set_exception(e)
                self.stats.record_failure(len(wave.pendings))
                continue
            self._collect_q.put(_SolvedWave(
                wave=wave, result=res, mismatch=mismatch, solve_s=solve_s))

    # -- pipeline stage 3: collector (materialize + resolve) -----------------

    def _collector_loop(self):
        while True:
            item = self._collect_q.get()
            if item is _SENTINEL:
                return
            solved: _SolvedWave = item
            wave = solved.wave
            res = solved.result
            tags = dict(wave_id=wave.wave_id, request_ids=wave.request_ids)
            try:
                t0 = time.perf_counter()
                v = res.v.detach().to("cpu", copy=True).numpy()
                mismatch = solved.mismatch.cpu().numpy().astype(np.float64)
                obs.interval("serve.d2h", t0, time.perf_counter(), **tags)
                real = len(wave.pendings)
                padded = wave.m0.shape[0]
                collect_s = 0.0
                # Stats are recorded BEFORE any future resolves: a client
                # that calls summary() the moment its last result arrives
                # must already see that request (and its wave) counted.
                ready = []
                for i, p in enumerate(wave.pendings):
                    gnorm0_i = float(res.gnorm0[i])
                    # cache_visits stays the *lookup-time* count (warm-start
                    # provenance); update() already bumps the stored count.
                    cache_visits = wave.visits[i]
                    if self.cache is not None:
                        self.cache.update(
                            p.request.subject, v[i], gnorm0_i, wave.key.grid)
                    t_done = time.perf_counter()
                    collect_s = t_done - t0
                    rr = RequestResult(
                        request_id=p.request_id,
                        subject=p.request.subject,
                        variant=wave.key.variant,
                        grid=wave.key.grid,
                        v=v[i],
                        mismatch_rel=float(mismatch[i]),
                        iters=int(res.iters[i]),
                        matvecs=int(res.matvecs[i]),
                        gnorm0=gnorm0_i,
                        rel_grad=float(res.rel_grad[i]),
                        converged=bool(res.converged[i]),
                        warm_started=wave.warm[i],
                        cache_visits=cache_visits,
                        wave_id=wave.wave_id,
                        wave_real=real,
                        wave_padded=padded,
                        queue_s=wave.t_dispatch - p.t_submit,
                        solve_s=solved.solve_s,
                        collect_s=collect_s,
                        latency_s=t_done - p.t_submit,
                    )
                    self.stats.record_request(
                        dict(request_id=p.request_id, subject=p.request.subject,
                             grid=list(wave.key.grid), variant=wave.key.variant,
                             warm_started=wave.warm[i], iters=rr.iters,
                             matvecs=rr.matvecs, gnorm0=rr.gnorm0,
                             mismatch_rel=rr.mismatch_rel,
                             latency_s=rr.latency_s, queue_s=rr.queue_s,
                             solve_s=rr.solve_s, wave_id=wave.wave_id),
                        t_done=t_done)
                    ready.append((p, rr))
                self.stats.record_wave(dict(
                    wave_id=wave.wave_id, grid=list(wave.key.grid),
                    variant=wave.key.variant, real=real, padded=padded,
                    utilization=real / max(padded, 1),
                    assemble_s=wave.assemble_s, solve_s=solved.solve_s,
                    collect_s=collect_s,
                    iters=[int(x) for x in res.iters[:real]],
                    warm=list(wave.warm)))
                obs.interval("serve.collect", t0, t0 + collect_s, **tags)
                for p, rr in ready:
                    p.future.set_result(rr)
            except Exception as e:
                for p in wave.pendings:
                    if not p.future.done():
                        p.future.set_exception(e)
                self.stats.record_failure(len(wave.pendings))

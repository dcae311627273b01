"""Registration serving launcher: asyncio front end over
``repro_torch.serve`` (port of ``repro.launch.serve_registration``).

    PYTHONPATH=src python -m repro_torch.launch.serve_registration --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_registration \\
        --requests 16 --grids 16,24 --rate 2.0 --subjects 6 --device cpu

Drives an open-loop request stream (Poisson arrivals at ``--rate`` req/s;
``--rate 0`` submits everything at once, the closed-loop burst) of synthetic
longitudinal studies against an in-process :class:`repro_torch.serve.Server`:
requests tagged with repeat subjects warm-start from the server's velocity
cache. Prints the per-request log and the SLO summary (p50/p99 latency,
pairs/sec, wave utilization, warm-vs-cold Newton iterations). ``--device``
(``cuda``, the default, or ``cpu``) is where the data is made and the waves
are solved; ``cuda`` without a card raises.
"""

from __future__ import annotations

import argparse
import asyncio
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def synthetic_study(grids: Sequence[Tuple[int, int, int]], n_requests: int,
                    n_subjects: int, seed: int = 0, amplitude: float = 0.5,
                    revisit_scale: float = 0.9, variant: str = "fd8-cubic",
                    measure: str = "ssd", device="cuda"):
    """Synthetic longitudinal request stream.

    ``n_subjects`` distinct subjects cycle through the request list; each
    subject keeps its grid and template (``data.synthetic.make_pair`` of a
    seed drawn for it from a ``torch.Generator(seed)``), and every *revisit*
    re-generates the reference image from a slightly rescaled true velocity
    (``revisit_scale``): the follow-up scan moved a little, so a warm start
    helps but the warm solve is not a trivial no-op. Returns
    ``repro_torch.serve.Request`` objects in arrival order, their images on
    ``device``.
    """
    from ..core import transport as _tr
    from ..data import synthetic
    from ..serve import Request

    gen = torch.Generator().manual_seed(int(seed))
    seeds = torch.randint(0, 2 ** 31 - 1, (n_subjects,), generator=gen).tolist()
    subjects = []
    for s in range(n_subjects):
        grid = tuple(grids[s % len(grids)])
        pair = synthetic.make_pair(seeds[s], grid, amplitude=amplitude, device=device)
        subjects.append((f"subject-{s:03d}", grid, pair))

    cfg = _tr.TransportConfig(interp="cubic_bspline", deriv="fd8", nt=4)
    visits = [0] * n_subjects
    requests: List[Request] = []
    for i in range(n_requests):
        s = i % n_subjects
        name, grid, pair = subjects[s]
        visits[s] += 1
        if visits[s] == 1:
            m1 = pair.m1
        else:
            # follow-up visit: the anatomy drifted — same template, a
            # reference transported by a rescaled velocity.
            scale = revisit_scale ** (visits[s] - 1)
            m1 = _tr.solve_state(pair.m0, scale * pair.v_true, cfg)[-1]
        requests.append(Request(m0=pair.m0, m1=m1, subject=name,
                                variant=variant, measure=measure))
    return requests


def poisson_delays(n: int, rate: float, seed: int = 0) -> List[float]:
    """Cumulative arrival offsets (seconds). ``rate <= 0`` = all at t=0."""
    if rate <= 0:
        return [0.0] * n
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    return list(np.cumsum(gaps))


async def run_stream(server, requests, delays: Optional[Sequence[float]] = None):
    """Submit ``requests`` at their arrival offsets; gather all results.

    The bridge between the server's ``concurrent.futures`` API and asyncio:
    each request sleeps until its arrival time, submits, and awaits the
    wrapped future. Results come back in submission order.
    """
    delays = delays if delays is not None else [0.0] * len(requests)

    async def one(req, delay):
        if delay > 0:
            await asyncio.sleep(delay)
        return await asyncio.wrap_future(server.submit(req))

    return await asyncio.gather(
        *(one(r, d) for r, d in zip(requests, delays)))


def serve_stream(server, requests, delays=None):
    """Sync wrapper around :func:`run_stream` (one event loop per call)."""
    return asyncio.run(run_stream(server, requests, delays))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny grids / few requests (CI-sized)")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--grids", default=None,
                    help="comma list of cubic grid sizes, e.g. 16,24")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate (req/s); 0 = burst")
    ap.add_argument("--subjects", type=int, default=None)
    ap.add_argument("--variant", default="fd8-cubic")
    ap.add_argument("--measure", default="ssd",
                    help="distance measure for every request "
                         "(ssd|ncc|ngf; a bucketing key)")
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--max-wait-ms", type=float, default=100.0)
    ap.add_argument("--max-newton", type=int, default=None)
    ap.add_argument("--tol", type=float, default=None,
                    help="relative-gradient stopping tolerance (default "
                         "0.25 smoke / 0.15 full: converge below the Newton "
                         "cap at demo grid sizes)")
    ap.add_argument("--cache-dir", default=None,
                    help="persist warm starts across runs (checkpoint dir)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ..serve import ServeConfig, Server

    if args.smoke:
        grid_sizes = [int(g) for g in (args.grids or "12,16").split(",")]
        n_requests = args.requests or 6
        n_subjects = args.subjects or 3
        max_newton = args.max_newton or 4
        tol = args.tol if args.tol is not None else 0.25
    else:
        grid_sizes = [int(g) for g in (args.grids or "16,24").split(",")]
        n_requests = args.requests or 16
        n_subjects = args.subjects or 6
        max_newton = args.max_newton or 12
        tol = args.tol if args.tol is not None else 0.15

    grids = [(g, g, g) for g in grid_sizes]
    requests = synthetic_study(grids, n_requests, n_subjects,
                               seed=args.seed, variant=args.variant,
                               measure=args.measure, device=args.device)
    delays = poisson_delays(n_requests, args.rate, seed=args.seed)

    cfg = ServeConfig(max_batch=args.max_batch,
                      max_wait_s=args.max_wait_ms / 1e3,
                      max_newton=max_newton, tol_rel_grad=tol,
                      cache_dir=args.cache_dir, device=args.device)
    pattern = "burst (closed-loop)" if args.rate <= 0 else \
        f"Poisson open-loop @ {args.rate:g} req/s"
    print(f"[serve-reg] {n_requests} requests, {n_subjects} subjects, "
          f"grids {grid_sizes}, {pattern}, device {args.device}")
    with Server(cfg) as server:
        results = serve_stream(server, requests, delays)
        for r in results:
            print(f"  #{r.request_id:03d} {r.subject} "
                  f"{'x'.join(map(str, r.grid))} "
                  f"{'warm' if r.warm_started else 'cold'} "
                  f"iters={r.iters} mismatch={r.mismatch_rel:.3f} "
                  f"latency={r.latency_s:.2f}s (queue {r.queue_s:.2f}s) "
                  f"wave={r.wave_id}[{r.wave_real}/{r.wave_padded}]")
        s = server.summary()
    print(f"[serve-reg] completed {s['completed']}/{s['submitted']} "
          f"in {s['waves']} waves; p50 {s['latency_p50_s']:.2f}s "
          f"p99 {s['latency_p99_s']:.2f}s, {s['pairs_per_sec']:.2f} pairs/s, "
          f"utilization {s['utilization_mean']:.2f}")
    if s["iters_mean_warm"] is not None and s["iters_mean_cold"] is not None:
        print(f"[serve-reg] Newton iters: cold {s['iters_mean_cold']:.1f} "
              f"vs warm {s['iters_mean_warm']:.1f}")
    if s["completed"] != n_requests:
        print(f"[serve-reg] requests were dropped: {s['completed']} of "
              f"{n_requests} completed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Registration as a service: submit a longitudinal stream to the server.

A clinic-style workload: several subjects, each scanned twice. Requests are
bucketed by grid size, batched into Newton-solve waves, and repeat subjects
warm-start from the server's velocity cache: the second visit converges in
fewer Newton iterations, measured against the same cold gradient reference.

    python examples_torch/serve_registration.py [--grid 16]
    python examples_torch/serve_registration.py --cache-dir /tmp/reg_cache
    python examples_torch/serve_registration.py --device cpu --grid 8
"""

import argparse

import _path  # noqa: F401

from repro_torch.launch.serve_registration import serve_stream, synthetic_study
from repro_torch.serve import ServeConfig, Server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=16)
    ap.add_argument("--subjects", type=int, default=3)
    ap.add_argument("--variant", default="fd8-cubic")
    ap.add_argument("--max-newton", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    grid = (args.grid,) * 3
    # two visits per subject: the second re-registers the same anatomy after
    # a small drift, so the cached velocity is a strong starting point
    requests = synthetic_study([grid], 2 * args.subjects, args.subjects, seed=0,
                               variant=args.variant, device=args.device)

    config = ServeConfig(max_batch=args.max_batch, max_wait_s=0.1,
                         max_newton=args.max_newton, tol_rel_grad=0.15,
                         cache_dir=args.cache_dir, device=args.device)
    with Server(config) as server:
        cold = serve_stream(server, requests[:args.subjects])    # visit 1 (cold)
        warm = serve_stream(server, requests[args.subjects:])    # visit 2 (warm)
        stats = server.summary()

    for c, w in zip(cold, warm):
        print(f"{c.subject}: cold iters={c.iters} (mismatch {c.mismatch_rel:.3f}, "
              f"{c.latency_s:.2f}s)  ->  warm iters={w.iters} "
              f"(mismatch {w.mismatch_rel:.3f}, {w.latency_s:.2f}s)")
    print(f"\n{stats['completed']} requests in {stats['waves']} waves, "
          f"p50 latency {stats['latency_p50_s']:.2f}s, "
          f"{stats['pairs_per_sec']:.2f} pairs/s, "
          f"mean wave utilization {stats['utilization_mean']:.2f}")
    print(f"Newton iterations: cold {stats['iters_mean_cold']:.1f} "
          f"vs warm {stats['iters_mean_warm']:.1f}")
    return stats


if __name__ == "__main__":
    main()

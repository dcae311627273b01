"""``"entry": "server"``: a longitudinal cohort sent to
``repro_torch.serve.Server``.

Every subject's first visit (cold) is registered in set-up, which fills the
warm-start cache, so the window measures the steady state of follow-up
visits. The mix's ``arrivals`` say when the window's visits are sent:

- ``{"kind": "closed"}``: one closed-loop client per subject, each sending
  its subject's next visit when the last one is answered;
- ``{"kind": "poisson", "rate_per_s": r, "seed": s}``: an open loop, visits
  sent at the times ``generator.arrivals`` draws, to the subjects in turn.

No visit is sent once ``seconds`` have passed; the window closes when every
visit sent in it has been answered, so that its rate counts all the work and
all the time. A seeded sample of the answers (host arrays) is judged after.
"""

from __future__ import annotations

import time
import traceback
from concurrent.futures import FIRST_COMPLETED, wait

import numpy as np
import torch

from .. import generator, trace
from .. import window as W
from ..reference import judge as J


def drive(run: W.Run, mix: dict, seed: int, seconds: float, traced: bool, solver: dict,
          program: dict) -> None:
    from repro_torch import serve

    dev = run.dev
    subjects = generator.cohort(mix, run.grid, run.nt, seed, dev)
    schedule = generator.arrivals(mix, seconds)
    srv = mix["server"]
    kw = W.solver_kwargs({**solver, **program.get("solver", {})})
    cfg = serve.ServeConfig(
        max_batch=srv["max_batch"], max_wait_s=srv["max_wait_s"], pad_waves=srv["pad_waves"],
        nt=kw["nt"], beta=kw["beta"], gamma=kw["gamma"], tol_rel_grad=kw["tol_rel_grad"],
        max_newton=kw["max_newton"], mixed_precision=kw["mixed_precision"],
        use_plan=kw["use_plan"], use_fused_matvec=kw["use_fused_matvec"], warm_start=True,
        cache_dir=None, device=dev)

    def request(s, k):
        return serve.Request(s.m0, s.visit(k), subject=s.name, variant=kw["variant"],
                             measure=kw["measure"])

    answered, outstanding, nxt = [], {}, [1] * len(subjects)

    def send(c):
        f = server.submit(request(subjects[c], nxt[c]))
        outstanding[f] = (c, nxt[c])
        nxt[c] += 1
        run.attempted += 1

    server = serve.Server(cfg).start()
    try:
        for f in [server.submit(request(s, 0)) for s in subjects]:
            f.result()
        W.begin_window(run)
        with trace.window(traced, dev) as tw:
            t0 = time.perf_counter()
            t_end = t0 + seconds
            if schedule is None:
                for c in range(len(subjects)):
                    send(c)
            j = 0
            while True:
                now = time.perf_counter()
                while schedule is not None and j < len(schedule) and t0 + schedule[j] <= now:
                    send(j % len(subjects))
                    j += 1
                if now >= t_end and not outstanding:
                    break
                if now >= t_end:
                    timeout = None
                elif schedule is not None and j < len(schedule):
                    timeout = max(0.0, min(t0 + schedule[j], t_end) - now)
                else:
                    timeout = t_end - now
                if not outstanding:
                    time.sleep(timeout)
                    continue
                done, _ = wait(list(outstanding), timeout=timeout, return_when=FIRST_COMPLETED)
                for f in done:
                    c, k = outstanding.pop(f)
                    try:
                        rr = f.result()
                    except Exception:
                        traceback.print_exc()
                        run.failed += 1
                        continue
                    answered.append((c, k, rr))
                    if schedule is None and time.perf_counter() < t_end:
                        send(c)
            run.window_s = time.perf_counter() - t0
        run.peak_bytes = W.peak(dev)
        run.trace = tw.result
    finally:
        server.stop()

    for c, k, rr in answered:
        run.failed += int(not rr.converged)
        run.requests.append(dict(client=c, visit=k, warm=rr.warm_started,
                                 latency_s=rr.latency_s, queue_s=rr.queue_s,
                                 wave_id=rr.wave_id, wave_real=rr.wave_real,
                                 wave_padded=rr.wave_padded, iters=rr.iters,
                                 matvecs=rr.matvecs))
    wrong = sum(rr.subject != subjects[c].name for c, _, rr in answered)

    rng = np.random.default_rng(int(seed))
    pick = rng.permutation(len(answered))[:mix["sample"]["answers"]]
    pb = J.problem(solver)
    per, ref = [], {}
    for i in sorted(int(x) for x in pick):
        c, k, rr = answered[i]
        s = subjects[c]
        m0 = torch.from_numpy(s.m0).to(dev)
        if c not in ref:
            ref[c] = J.gnorm_cold(m0, torch.from_numpy(s.visit(0)).to(dev), pb)
        per.append(J.judge(m0, torch.from_numpy(s.visit(k)).to(dev),
                           torch.from_numpy(rr.v).to(dev),
                           dict(rel_grad=rr.rel_grad, mismatch_rel=rr.mismatch_rel,
                                gnorm0=rr.gnorm0), pb, ref[c]))
    run.checks = J.worst(per)
    run.checks["wrong_subject"] = float(wrong)
    run.judged = len(per)

"""``"entry": "register"``: one closed-loop client calling
``repro_torch.core.registration.register`` on the mix's registrations in
turn, each ending in a synchronize, until ``seconds`` have passed; the
registration running then ends the window.

Every registration of the window has inputs of its own (``generator.pool``).
The judged answers are a sample drawn from the seed among the window's first
``sample.from_first`` registrations, copied to the host as they finish, and
the window's last answer, copied once the window has closed; no answer is
held on the card beyond the registration that made it.
"""

from __future__ import annotations

import time
import traceback

import numpy as np
import torch

from .. import generator, trace
from .. import window as W
from ..reference import judge as J


def _to_host(res) -> dict:
    return dict(v=res.v.detach().cpu(), m_warped=res.m_warped.detach().cpu(),
                rel_grad=res.rel_grad, mismatch_rel=res.mismatch_rel, detF=res.detF)


def drive(run: W.Run, mix: dict, seed: int, seconds: float, traced: bool, solver: dict,
          program: dict) -> None:
    from repro_torch.core import registration as R

    dev = run.dev
    warm, *pairs = generator.pool(mix, run.grid, run.nt, seed, dev)
    kw = W.solver_kwargs({**solver, **program.get("solver", {})})
    register = program.get("register", R.register)
    register(warm.m0, warm.m1, device=dev, **kw)
    del warm
    sample = mix["sample"]
    picked = {int(i) for i in np.random.default_rng(int(seed)).permutation(
        sample["from_first"])[:sample["answers"]]}
    kept = {}
    res = None
    W.begin_window(run)
    with trace.window(traced, dev) as tw:
        t0 = time.perf_counter()
        while True:
            i = len(run.solves)
            pair = pairs[i % len(pairs)]
            run.attempted += 1
            try:
                with torch.profiler.record_function("regbench.register"):
                    res = register(pair.m0, pair.m1, device=dev, **kw)
                    W.sync(dev)
            except Exception:
                traceback.print_exc()
                run.failed += 1
                res = None
                break
            run.solves.append(dict(iters=res.iters, matvecs=res.matvecs,
                                   evals=len(res.history),
                                   ls=sum(int(h["ls_evals"]) for h in res.history),
                                   converged=bool(res.converged)))
            run.failed += int(not res.converged)
            if time.perf_counter() - t0 >= seconds:
                break
            if i in picked:
                kept[i] = _to_host(res)
            res = None
        run.window_s = time.perf_counter() - t0
    run.peak_bytes = W.peak(dev)
    run.trace = tw.result
    if res is not None:
        kept[len(run.solves) - 1] = _to_host(res)
    del res

    pb = J.problem(solver)
    per = []
    for i in sorted(kept):
        m0 = torch.from_numpy(pairs[i % len(pairs)].m0).to(dev)
        m1 = torch.from_numpy(pairs[i % len(pairs)].m1).to(dev)
        ans = kept.pop(i)
        per.append(J.judge(m0, m1, ans.pop("v").to(dev), ans, pb, J.gnorm_cold(m0, m1, pb)))
        del m0, m1, ans
    run.checks = J.worst(per)
    run.judged = len(per)

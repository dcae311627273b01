"""The comparison that decides ``correct``: an answer is judged by what it
says, against the plain reference worked out again from the request's own
images.

A registration answer is a velocity ``v`` with what the program reports of
it. The reference evaluates the objective's gradient, the transported image
and the deformation at that ``v`` and returns, per answer:

- ``rel_grad``: ||g(v)|| / ||g_ref|| by the reference, held to the
  configuration's own stopping tolerance (the Newton stop);
- ``rel_grad_gap``: the gap between the program's and the reference's
  relative gradient, over the reference's;
- ``mismatch_gap``: the same for ||m(1) - m1|| / ||m1 - m0||;
- ``warp_gap``: ||m_warped - m_ref(1)|| / ||m1 - m0|| (answers that carry
  the warped image);
- ``detf_gap``: the largest gap of det F's min, mean and max, over the
  reference's (answers that carry det F);
- ``gnorm0_gap``: the gap of the stopping reference ||g_ref|| (answers that
  carry it).

``g_ref`` is the gradient at v = 0 of the pair the subject was first
registered on (a cold request's own pair).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from . import claire as C


def problem(solver: dict, weights: Optional[torch.dtype] = "config") -> C.Problem:
    """The reference problem of a configuration's ``solver`` block;
    ``weights`` overrides the weights' precision (controls)."""
    if weights == "config":
        weights = torch.bfloat16 if solver["mixed_precision"] else None
    return C.Problem(beta=solver["beta"], gamma=solver["gamma"], nt=solver["nt"],
                     tol_rel_grad=solver["tol_rel_grad"], max_newton=solver["max_newton"],
                     prec=C.Precision(weights=weights), measure=solver["measure"])


def gnorm_cold(m0: torch.Tensor, m1: torch.Tensor, pb: C.Problem) -> float:
    """||g(0)||: the stopping reference of a cold solve of (m0, m1)."""
    return C.evaluate(m0, m1, torch.zeros((3,) + tuple(m0.shape), device=m0.device), pb).gnorm


def _gap(a: float, b: float) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def judge(m0: torch.Tensor, m1: torch.Tensor, v: torch.Tensor, reported: dict,
          pb: C.Problem, gnorm_ref: float) -> Dict[str, float]:
    """The numbers of one answer. ``reported`` holds ``rel_grad`` and
    ``mismatch_rel``, and may hold ``m_warped``, ``detF`` and ``gnorm0``."""
    with torch.no_grad():
        ev = C.evaluate(m0, m1, v, pb)
        m_ref = ev.m_traj[-1]
        rel = ev.gnorm / gnorm_ref if gnorm_ref > 0 else 0.0
        out = dict(rel_grad=rel,
                   rel_grad_gap=_gap(reported["rel_grad"], rel),
                   mismatch_gap=_gap(reported["mismatch_rel"],
                                     C.relative_mismatch(m_ref, m1, m0)))
        if reported.get("m_warped") is not None:
            w = torch.as_tensor(reported["m_warped"]).to(m0.device, torch.float32)
            out["warp_gap"] = float(C.norm(w - m_ref) / C.norm(m1 - m0))
        if reported.get("detF") is not None:
            ref = C.det_f(v, ev.foot_fwd, pb.nt, pb.prec)
            out["detf_gap"] = max(_gap(reported["detF"][k], ref[k]) for k in ref)
        if reported.get("gnorm0") is not None:
            out["gnorm0_gap"] = _gap(reported["gnorm0"], gnorm_ref)
    return out


def worst(per_answer: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest reading over the answers (every number is
    worse when larger)."""
    out: Dict[str, float] = {}
    for nums in per_answer:
        for k, x in nums.items():
            out[k] = max(out.get(k, x), x)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit, and every limited number read."""
    return all(k in numbers and numbers[k] <= lim for k, lim in limits.items())

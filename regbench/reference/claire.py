"""Plain PyTorch reference of the registration the benchmark measures.

CLAIRE's stationary-velocity problem (arXiv:2004.08893, eq. (1)) on the
periodic grid (0, 2*pi)^3: a distance measure of ``measures/`` (SSD, NCC),
H1-div regularisation ``A v = beta (-Lap) v + gamma grad div v``,
semi-Lagrangian transport with an RK2 characteristic trace and ``nt``
steps, FD8 first derivatives, cubic B-spline interpolation on coefficients
from the 15-tap FIR prefilter, and a Gauss-Newton-Krylov solve (PCG with
the spectral preconditioner ``(beta A)^-1``, Armijo backtracking,
Eisenstat-Walker forcing).

Written from the paper's equations with ``torch`` operations only: every
stencil is a sum of ``torch.roll``s, every interpolation a loop over the 64
taps with ``index_select``, every spectral operator ``torch.fft``. It imports
nothing of the program it judges. Where a configuration states bfloat16
interpolation weights, each axis's four weights are computed in fp32 by one
plain expression and rounded to bfloat16 (``Precision``), the product of
the first two axes' weights is rounded to bfloat16 as well, and the third
factor and the accumulation are fp32.

Shapes: scalar fields ``(N1, N2, N3)``, vector fields ``(3, N1, N2, N3)``,
query points ``(3, ...)`` in index units.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Dict, List, Optional, Tuple

import torch

TWO_PI = 2.0 * math.pi
FD8 = (4.0 / 5.0, -1.0 / 5.0, 4.0 / 105.0, -1.0 / 280.0)
_Z1 = math.sqrt(3.0) - 2.0
#: (c0, ..., c7): the truncated inverse B-spline filter -6 z1^(|n|+1) / (1 - z1^2)
PREFILTER = tuple(-6.0 * _Z1 ** (n + 1) / (1.0 - _Z1 * _Z1) for n in range(8))


@dataclasses.dataclass(frozen=True)
class Precision:
    """How the interpolation weights are rounded: ``weights`` None (fp32),
    ``torch.bfloat16`` or a float8 dtype."""

    weights: Optional[torch.dtype] = None


@dataclasses.dataclass(frozen=True)
class Problem:
    beta: float = 5e-4
    gamma: float = 1e-4
    nt: int = 4
    tol_rel_grad: float = 5e-2
    max_newton: int = 50
    max_pcg: int = 500
    forcing_max: float = 0.5
    ls_max: int = 12
    ls_c1: float = 1e-4
    prec: Precision = Precision()
    #: the distance measure, ``measures/<measure>.py``
    measure: str = "ssd"


def measure(pb: Problem):
    """The module of ``pb``'s distance measure: ``value(mf, m1)`` (the
    mismatch part of J), ``terminal(mf, m1)`` (lambda(1) = -dD/dm(1)) and
    ``gn_terminal(mt1, mf, m1)`` (lt(1) = -H_D mt(1), Gauss-Newton)."""
    return importlib.import_module(f"{__package__}.measures.{pb.measure}")


# ---------------------------------------------------------------------------
# Grid, stencils, spectral operators
# ---------------------------------------------------------------------------


def spacing(shape) -> Tuple[float, float, float]:
    return tuple(TWO_PI / float(n) for n in shape)


def inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    h = spacing(a.shape[-3:])
    return (h[0] * h[1] * h[2]) * torch.sum(a * b)


def norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(inner(a, a))


def index_coords(shape, device) -> torch.Tensor:
    axes = [torch.arange(n, dtype=torch.float32, device=device) for n in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0)


def _h(shape, device) -> torch.Tensor:
    return torch.tensor(spacing(shape), dtype=torch.float32, device=device).reshape(3, 1, 1, 1)


def prefilter(f: torch.Tensor) -> torch.Tensor:
    """B-spline coefficients: the 15-tap symmetric FIR along each of the
    trailing three axes, periodic."""
    for d in (-3, -2, -1):
        acc = PREFILTER[0] * f
        for k in range(1, 8):
            acc = acc + PREFILTER[k] * (torch.roll(f, -k, d) + torch.roll(f, k, d))
        f = acc
    return f


def fd8_partial(f: torch.Tensor, axis: int) -> torch.Tensor:
    d = axis - 3
    acc = torch.zeros_like(f)
    for k, c in enumerate(FD8, start=1):
        acc = acc + c * (torch.roll(f, -k, d) - torch.roll(f, k, d))
    return acc * (1.0 / spacing(f.shape[-3:])[axis])


def grad(f: torch.Tensor) -> torch.Tensor:
    return torch.stack([fd8_partial(f, a) for a in range(3)], dim=-4)


def div(w: torch.Tensor) -> torch.Tensor:
    return fd8_partial(w[0], 0) + fd8_partial(w[1], 1) + fd8_partial(w[2], 2)


def _wavenumbers(shape, device):
    n1, n2, n3 = shape
    k = (torch.fft.fftfreq(n1, d=1.0 / n1, device=device).float().reshape(n1, 1, 1),
         torch.fft.fftfreq(n2, d=1.0 / n2, device=device).float().reshape(1, n2, 1),
         torch.fft.rfftfreq(n3, d=1.0 / n3, device=device).float().reshape(1, 1, -1))
    # k k^T couplings drop the sign-ambiguous Nyquist modes; |k|^2 keeps them.
    kt = tuple(torch.where((n % 2 == 0) & (torch.abs(ki) == n // 2), 0.0, ki)
               for n, ki in zip(shape, k))
    k2 = k[0] ** 2 + k[1] ** 2 + k[2] ** 2
    kt2 = kt[0] ** 2 + kt[1] ** 2 + kt[2] ** 2
    return kt, k2, kt2


def regop(v: torch.Tensor, beta: float, gamma: float) -> torch.Tensor:
    """A v = beta (-Lap) v - gamma grad div v, spectrally."""
    shape = tuple(v.shape[-3:])
    kt, k2, _ = _wavenumbers(shape, v.device)
    vh = torch.fft.rfftn(v, dim=(-3, -2, -1))
    kdv = kt[0] * vh[0] + kt[1] * vh[1] + kt[2] * vh[2]
    out = torch.stack([beta * k2 * vh[a] + gamma * kt[a] * kdv for a in range(3)])
    return torch.fft.irfftn(out, s=shape, dim=(-3, -2, -1)).float()


def inv_regop(v: torch.Tensor, beta: float, gamma: float) -> torch.Tensor:
    """(beta A)^-1 by Sherman-Morrison, the identity on the zero mode."""
    shape = tuple(v.shape[-3:])
    kt, k2, kt2 = _wavenumbers(shape, v.device)
    vh = torch.fft.rfftn(v, dim=(-3, -2, -1))
    kdv = kt[0] * vh[0] + kt[1] * vh[1] + kt[2] * vh[2]
    lap = beta * k2
    safe = torch.where(lap > 0, lap, 1.0)
    corr = gamma / torch.where(k2 > 0, beta * k2 + gamma * kt2, 1.0)
    out = torch.stack([torch.where(lap > 0, (vh[a] - corr * kt[a] * kdv) / safe, vh[a])
                       for a in range(3)])
    return torch.fft.irfftn(out, s=shape, dim=(-3, -2, -1)).float()


def reg_energy(v: torch.Tensor, beta: float, gamma: float) -> torch.Tensor:
    return 0.5 * inner(regop(v, beta, gamma), v)


# ---------------------------------------------------------------------------
# Cubic B-spline interpolation
# ---------------------------------------------------------------------------


def bspline_weights(t: torch.Tensor):
    """The uniform cubic B-spline basis at offsets -1, 0, 1, 2 (fp32)."""
    t2 = t * t
    t3 = t2 * t
    return ((1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0, (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0,
            (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0, t3 / 6.0)


def weights(t: torch.Tensor, prec: Precision):
    """The four weights at fractions ``t``, rounded to ``prec.weights``."""
    w = bspline_weights(t)
    return w if prec.weights is None else tuple(x.to(prec.weights) for x in w)


def interp(coef: torch.Tensor, q: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Cubic B-spline evaluation of coefficients ``coef`` ``(..., N1, N2,
    N3)`` at ``q`` ``(3, *out)``, periodic, tap order a -> b -> c, fp32
    accumulation."""
    shape = tuple(coef.shape[-3:])
    n1, n2, n3 = shape
    lead = tuple(coef.shape[:-3])
    out = tuple(q.shape[1:])
    flat = coef.reshape(-1, n1 * n2 * n3)
    qf = torch.floor(q)
    t = q - qf
    base = qf.long() - 1
    w = [weights(t[a], prec) for a in range(3)]
    i1 = [(torch.remainder(base[0] + a, n1) * (n2 * n3)).reshape(-1) for a in range(4)]
    i2 = [(torch.remainder(base[1] + b, n2) * n3).reshape(-1) for b in range(4)]
    i3 = [torch.remainder(base[2] + c, n3).reshape(-1) for c in range(4)]
    acc = torch.zeros((flat.shape[0], i1[0].numel()), dtype=torch.float32, device=coef.device)
    for a in range(4):
        for b in range(4):
            iab = i1[a] + i2[b]
            # the product rounded to the weights' type (fp32, bf16, fp8)
            wab = (w[0][a].float() * w[1][b].float()).to(w[0][a].dtype)
            for c in range(4):
                tw = (wab.float() * w[2][c].float()).reshape(1, -1)
                acc = acc + tw * flat.index_select(1, iab + i3[c])
    return acc.reshape(lead + out)


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------


def footpoints(v: torch.Tensor, dt: float, sign: float, prec: Precision) -> torch.Tensor:
    """RK2 backward trace X = x - s dt v(x - s dt/2 v(x)) in index units."""
    shape = tuple(v.shape[-3:])
    h = _h(shape, v.device)
    x = index_coords(shape, v.device)
    v_mid = interp(prefilter(v), x - sign * (0.5 * dt) * v / h, prec)
    return x - sign * dt * v_mid / h


def sl(f: torch.Tensor, foot: torch.Tensor, prec: Precision) -> torch.Tensor:
    """One SL step of the state or adjoint solves: f(X)."""
    return interp(prefilter(f), foot, prec)


def state(m0: torch.Tensor, foot: torch.Tensor, nt: int, prec: Precision) -> torch.Tensor:
    traj = [m0]
    for _ in range(nt):
        traj.append(sl(traj[-1], foot, prec))
    return torch.stack(traj)


def adjoint(lam1: torch.Tensor, foot_adj: torch.Tensor, divv: torch.Tensor, nt: int,
            prec: Precision) -> torch.Tensor:
    """-dl/dt - div(l v) = 0 backwards from l(1), RK2 with source (div v) l;
    the trajectory in forward time order."""
    dt = 1.0 / nt
    traj = [lam1]
    lam = lam1
    for _ in range(nt):
        adv, k1 = sl(torch.stack([lam, divv * lam]), foot_adj, prec)
        k2 = divv * (adv + dt * k1)
        lam = adv + 0.5 * dt * (k1 + k2)
        traj.append(lam)
    return torch.stack(traj[::-1])


def body_force(lam_traj: torch.Tensor, grad_m: torch.Tensor) -> torch.Tensor:
    """Trapezoidal int_0^1 lambda grad m dt."""
    nt = lam_traj.shape[0] - 1
    dt = 1.0 / nt
    acc = torch.zeros_like(grad_m[0])
    for t in range(nt + 1):
        w = 0.5 * dt if t in (0, nt) else dt
        acc = acc + w * lam_traj[t][None] * grad_m[t]
    return acc


@dataclasses.dataclass
class Evaluation:
    """The reduced gradient at ``v`` and what the Hessian reuses."""

    g: torch.Tensor
    gnorm: float
    m_traj: torch.Tensor
    grad_m: torch.Tensor
    foot_fwd: torch.Tensor
    foot_adj: torch.Tensor
    divv: torch.Tensor
    j: torch.Tensor
    m1: torch.Tensor


def evaluate(m0, m1, v, pb: Problem) -> Evaluation:
    """g(v) = beta A v + int_0^1 lambda grad m dt, and J(v)."""
    dt = 1.0 / pb.nt
    foot_fwd = footpoints(v, dt, 1.0, pb.prec)
    foot_adj = footpoints(v, dt, -1.0, pb.prec)
    divv = div(v)
    m_traj = state(m0, foot_fwd, pb.nt, pb.prec)
    meas = measure(pb)
    lam_traj = adjoint(meas.terminal(m_traj[-1], m1), foot_adj, divv, pb.nt, pb.prec)
    grad_m = grad(m_traj)
    av = regop(v, pb.beta, pb.gamma)
    g = av + body_force(lam_traj, grad_m)
    j = meas.value(m_traj[-1], m1) + 0.5 * inner(av, v)
    return Evaluation(g=g, gnorm=float(norm(g)), m_traj=m_traj, grad_m=grad_m,
                      foot_fwd=foot_fwd, foot_adj=foot_adj, divv=divv, j=j, m1=m1)


def objective(m0, m1, v, pb: Problem) -> torch.Tensor:
    foot = footpoints(v, 1.0 / pb.nt, 1.0, pb.prec)
    mf = state(m0, foot, pb.nt, pb.prec)[-1]
    return measure(pb).value(mf, m1) + reg_energy(v, pb.beta, pb.gamma)


def relative_mismatch(m_final, m1, m0) -> float:
    den = float(norm(m1 - m0))
    return float(norm(m_final - m1)) / den if den > 0 else 0.0


def det_f(v: torch.Tensor, foot_fwd: torch.Tensor, nt: int, prec: Precision) -> Dict[str, float]:
    """det(I + grad u) of the deformation y = x + u, u composed over the nt
    steps along the forward footpoints: min, mean and max."""
    shape = tuple(v.shape[-3:])
    h = _h(shape, v.device)
    disp = (foot_fwd - index_coords(shape, v.device)) * h
    u = torch.zeros_like(v)
    for _ in range(nt):
        u = interp(prefilter(u), foot_fwd, prec) + disp
    d = [fd8_partial(u, j) for j in range(3)]
    f00, f01, f02 = 1.0 + d[0][0], d[1][0], d[2][0]
    f10, f11, f12 = d[0][1], 1.0 + d[1][1], d[2][1]
    f20, f21, f22 = d[0][2], d[1][2], 1.0 + d[2][2]
    det = (f00 * (f11 * f22 - f12 * f21) - f01 * (f10 * f22 - f12 * f20)
           + f02 * (f10 * f21 - f11 * f20))
    return dict(min=float(det.min()), mean=float(det.mean()), max=float(det.max()))


# ---------------------------------------------------------------------------
# Gauss-Newton-Krylov solve (the reference put in the program's place)
# ---------------------------------------------------------------------------


def hessian_matvec(vt, ev: Evaluation, pb: Problem) -> torch.Tensor:
    """H vt = beta A vt + int lt grad m dt, with the incremental state
    d mt/dt + v.grad mt = -vt.grad m and lt(1) = -mt(1)."""
    dt = 1.0 / pb.nt
    src = -torch.sum(vt[None] * ev.grad_m, dim=1)
    mt = torch.zeros_like(src[0])
    for j in range(pb.nt):
        adv, s_adv = sl(torch.stack([mt, src[j]]), ev.foot_fwd, pb.prec)
        mt = adv + 0.5 * dt * (s_adv + src[j + 1])
    lt = adjoint(measure(pb).gn_terminal(mt, ev.m_traj[-1], ev.m1), ev.foot_adj, ev.divv,
                 pb.nt, pb.prec)
    return regop(vt, pb.beta, pb.gamma) + body_force(lt, ev.grad_m)


def pcg(matvec, b, precond, tol: float, max_iters: int):
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = inner(r, z)
    bnorm = norm(b)
    k = 0
    while float(norm(r)) > tol * float(bnorm) and k < max_iters:
        hp = matvec(p)
        php = inner(p, hp)
        alpha = rz / php if float(php) > 0 else torch.zeros_like(rz)
        x, r = x + alpha * p, r - alpha * hp
        z = precond(r)
        rz_new = inner(r, z)
        p = z + (rz_new / rz if float(rz) != 0 else 0.0) * p
        rz = rz_new
        k += 1
    return x, k


@dataclasses.dataclass
class Solution:
    v: torch.Tensor
    iters: int
    matvecs: int
    rel_grad: float
    converged: bool
    history: List[dict]


def solve(m0, m1, pb: Problem, v0=None, gnorm_ref: Optional[float] = None) -> Solution:
    """g(v) = 0 by Gauss-Newton-Krylov; stops at ||g|| <= tol ||g_ref||
    (``gnorm_ref``, else the first gradient's norm)."""
    v = torch.zeros((3,) + tuple(m0.shape), device=m0.device) if v0 is None else v0
    precond = lambda r: inv_regop(r, pb.beta, pb.gamma)  # noqa: E731
    g0, prev, rel = gnorm_ref, None, 1.0
    iters = matvecs = 0
    history = []
    for _ in range(pb.max_newton):
        eta = pb.forcing_max if prev is None else min(pb.forcing_max, (prev / g0) ** 0.5)
        ev = evaluate(m0, m1, v, pb)
        g0 = ev.gnorm if g0 is None else g0
        rel = ev.gnorm / g0 if g0 > 0 else 0.0
        vt, k = pcg(lambda p: hessian_matvec(p, ev, pb), -ev.g, precond, eta, pb.max_pcg)
        matvecs += k
        slope = float(inner(ev.g, vt))
        a, trials = 1.0, 0
        while (float(objective(m0, m1, v + a * vt, pb)) > float(ev.j) + pb.ls_c1 * a * slope
               and trials < pb.ls_max):
            a *= 0.5
            trials += 1
        history.append(dict(gnorm=ev.gnorm, rel_grad=rel, pcg=k, ls=trials + 1))
        if rel <= pb.tol_rel_grad:
            break
        v = v + a * vt if trials < pb.ls_max else v - 0.1 * precond(ev.g)
        prev = ev.gnorm
        iters += 1
    return Solution(v=v, iters=iters, matvecs=matvecs, rel_grad=rel,
                    converged=rel <= pb.tol_rel_grad, history=history)

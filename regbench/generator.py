"""The benchmark's one traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and makes the registration problems from the seed.

Every image is a brain-like phantom (a skull envelope times smooth tissue
blobs and finer folds, in [0, 1]) and its partner is the phantom transported
by a smooth random stationary velocity with max |v| = ``amplitude``
(physical units), by the reference's semi-Lagrangian state solve, its
intensities then mapped by ``contrast`` (``"same"``, default, or
``"inverted"``, 1 - m: a multi-modal pair, for the NCC measure). The
phantoms and velocities come from the mix's own fixed seeds; ``--seed``
draws each problem's circular shift of the periodic grid, so every seed
gets the same problems in other positions: the same work, in the same
order, on other arrays (the discretisation is shift-invariant up to
rounding).

- ``pool``: a ``register`` mix's ``pool.registrations`` pairs, each a base
  pair (``pool.seeds`` in turn) under a shift of its own, so no two
  registrations share inputs; the first is the warm-up's;
- ``cohort``: a ``server`` mix's subjects; a subject's first visit is its
  pair, each later visit moves the reference by the velocity scaled by
  ``revisit_scale`` to the visit's power, cycling over ``drift_levels``
  levels after the first visit;
- ``arrivals``: the send times of an open-loop mix (``arrivals.kind``
  ``"poisson"``: exponential gaps at ``rate_per_s`` from ``arrivals.seed``,
  the same on every ``--seed``), None for a closed loop.

Images are handed out as host float32 arrays, as a caller that loads scans
holds them.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .reference import claire as C

TRAFFIC = Path(__file__).resolve().parent / "traffic"


def load(mix: str) -> dict:
    return json.loads((TRAFFIC / f"{mix}.json").read_text())


def _uniform(gen, size, lo, hi, dev):
    return lo + (hi - lo) * torch.rand(size, generator=gen, device=dev)


def _blobs(gen, x, n_blobs, sigma_rng, dev):
    centers = _uniform(gen, (n_blobs, 3), 1.5, 2 * math.pi - 1.5, dev).tolist()
    sigmas = _uniform(gen, (n_blobs,), *sigma_rng, dev).tolist()
    weights = _uniform(gen, (n_blobs,), 0.4, 1.0, dev).tolist()
    out = torch.zeros_like(x[0])
    for c, s, w in zip(centers, sigmas, weights):
        d2 = (x[0] - c[0]) ** 2 + (x[1] - c[1]) ** 2 + (x[2] - c[2]) ** 2
        out = out + w * torch.exp(-d2 / (2 * s * s))
    return out


def phantom(gen, shape, dev) -> torch.Tensor:
    """Brain-like image in [0, 1]: skull envelope * (tissue + folds)."""
    h = C.spacing(shape)
    x = C.index_coords(shape, dev) * torch.tensor(h, device=dev).reshape(3, 1, 1, 1)
    r2 = (((x[0] - math.pi) / 2.2) ** 2 + ((x[1] - math.pi) / 1.9) ** 2
          + ((x[2] - math.pi) / 2.2) ** 2)
    envelope = torch.sigmoid((1.0 - r2) * 8.0)
    img = envelope * (0.55 * _blobs(gen, x, 12, (0.35, 0.9), dev)
                      + 0.45 * _blobs(gen, x, 24, (0.15, 0.35), dev))
    return img / torch.clamp(torch.max(img), min=1e-6)


def velocity(gen, shape, amplitude, sigma_vox, dev) -> torch.Tensor:
    """White noise smoothed by a spectral Gaussian, scaled to max |v| =
    ``amplitude``."""
    v = torch.randn((3,) + tuple(shape), generator=gen, device=dev)
    sig = (sigma_vox * shape[0] / 64.0 if shape[0] >= 64 else sigma_vox) * C.spacing(shape)[0]
    n1, n2, n3 = shape
    k2 = (torch.fft.fftfreq(n1, 1.0 / n1, device=dev).reshape(-1, 1, 1) ** 2
          + torch.fft.fftfreq(n2, 1.0 / n2, device=dev).reshape(1, -1, 1) ** 2
          + torch.fft.rfftfreq(n3, 1.0 / n3, device=dev).reshape(1, 1, -1) ** 2)
    v = torch.fft.irfftn(torch.exp(-0.5 * sig ** 2 * k2) * torch.fft.rfftn(v, dim=(-3, -2, -1)),
                         s=tuple(shape), dim=(-3, -2, -1)).float()
    return amplitude / torch.clamp(torch.sqrt(torch.sum(v * v, dim=0)).max(), min=1e-6) * v


def transport(m0, v, nt) -> torch.Tensor:
    """m0 carried along v for unit time (fp32 weights)."""
    prec = C.Precision()
    return C.state(m0, C.footpoints(v, 1.0 / nt, 1.0, prec), nt, prec)[-1]


def _base(sub_seed: int, shape, params, dev):
    gen = torch.Generator(device=dev).manual_seed(int(sub_seed))
    m0 = phantom(gen, shape, dev)
    return m0, velocity(gen, shape, params["amplitude"], params["sigma_vox"], dev)


def _host(t: torch.Tensor, shift) -> np.ndarray:
    return torch.roll(t, shifts=shift, dims=(0, 1, 2)).cpu().numpy()


CONTRAST = {"same": lambda m: m, "inverted": lambda m: 1.0 - m}


def _partner(m0, v, nt, params) -> torch.Tensor:
    return CONTRAST[params.get("contrast", "same")](transport(m0, v, nt))


def _shifts(rng, shape, n: int):
    """``n`` distinct circular shifts of the grid."""
    out: List[tuple] = []
    while len(out) < n:
        s = tuple(int(x) for x in rng.integers(0, shape, size=3))
        if s not in out:
            out.append(s)
    return out


@dataclasses.dataclass
class Pair:
    m0: np.ndarray
    m1: np.ndarray


def pool(mix: dict, shape, nt: int, seed: int, dev) -> List[Pair]:
    """A ``register`` mix's pairs in the order its client sends them, the
    warm-up's first."""
    p = mix["pool"]
    n = p["registrations"]
    shifts = _shifts(np.random.default_rng(int(seed)), shape, n)
    pairs: List[Optional[Pair]] = [None] * n
    with torch.no_grad():
        for b, s in enumerate(p["seeds"]):
            m0, v = _base(s, shape, p, dev)
            m1 = _partner(m0, v, nt, p)
            for i in range(b, n, len(p["seeds"])):
                pairs[i] = Pair(_host(m0, shifts[i]), _host(m1, shifts[i]))
            del m0, v, m1
    return pairs


@dataclasses.dataclass
class Subject:
    name: str
    m0: np.ndarray
    m1: List[np.ndarray]     # the reference of each drift level, level 0 first

    def visit(self, k: int) -> np.ndarray:
        """The reference of the subject's k-th visit (0 = first)."""
        levels = len(self.m1)
        return self.m1[0] if k == 0 else self.m1[1 + (k - 1) % (levels - 1)]


def cohort(mix: dict, shape, nt: int, seed: int, dev) -> List[Subject]:
    """A ``server`` mix's subjects, one per client, in client order."""
    rng = np.random.default_rng(int(seed))
    c = mix["cohort"]
    subjects = []
    with torch.no_grad():
        for s in c["seeds"]:
            m0, v = _base(s, shape, c, dev)
            shift = tuple(int(x) for x in rng.integers(0, shape, size=3))
            m1 = [_host(_partner(m0, c["revisit_scale"] ** k * v, nt, c), shift)
                  for k in range(c["drift_levels"])]
            subjects.append(Subject(f"subject-{s}", _host(m0, shift), m1))
    return subjects


def arrivals(mix: dict, seconds: float) -> Optional[List[float]]:
    """Send times in [0, seconds) of an open-loop mix; None for a closed
    loop."""
    a = mix.get("arrivals", {"kind": "closed"})
    if a["kind"] == "closed":
        return None
    if a["kind"] != "poisson":
        raise ValueError(f"unknown arrivals kind {a['kind']!r}")
    rng = np.random.default_rng(int(a["seed"]))
    times, t = [], 0.0
    while True:
        t += float(rng.exponential(1.0 / a["rate_per_s"]))
        if t >= seconds:
            return times
        times.append(t)

"""Synthetic 3D image pairs (port of ``repro.data.synthetic``): brain-like
phantoms warped by a random smooth stationary velocity.

Every random number is drawn from a CPU ``torch.Generator(seed)`` and only
then moved to the device, so one seed gives the same pair on either device
(to the device's rounding). PyTorch's generator is not JAX's: the same seed
gives another pair than ``repro.data.synthetic``; tests that compare the two
packages hand the JAX pair over as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from .. import device as _device
from ..core import grid as _grid
from ..core import spectral as _spec
from ..core import transport as _tr


@dataclasses.dataclass
class ImagePair:
    m0: torch.Tensor        # template
    m1: torch.Tensor        # reference
    labels0: torch.Tensor   # binary label mask of m0
    labels1: torch.Tensor   # binary label mask of m1
    v_true: torch.Tensor    # velocity that generated m1 from m0


def _uniform(gen, size, lo, hi):
    return lo + (hi - lo) * torch.rand(size, generator=gen, dtype=torch.float32)


def _blobs(gen, x, n_blobs: int, sigma_rng=(0.35, 0.9)) -> torch.Tensor:
    centers = _uniform(gen, (n_blobs, 3), 1.5, 2 * math.pi - 1.5).tolist()
    sigmas = _uniform(gen, (n_blobs,), *sigma_rng).tolist()
    weights = _uniform(gen, (n_blobs,), 0.4, 1.0).tolist()
    out = torch.zeros_like(x[0])
    for c, s, w in zip(centers, sigmas, weights):
        d2 = (x[0] - c[0]) ** 2 + (x[1] - c[1]) ** 2 + (x[2] - c[2]) ** 2
        out = out + w * torch.exp(-d2 / (2 * s * s))
    return out


def brain_phantom(gen: torch.Generator, shape: Tuple[int, int, int],
                  device="cpu") -> torch.Tensor:
    """Brain-like scalar image in [0, 1]: skull envelope * (tissue + folds)."""
    x = _grid.coords(shape, device=device)
    c = math.pi
    r2 = ((x[0] - c) / 2.2) ** 2 + ((x[1] - c) / 1.9) ** 2 + ((x[2] - c) / 2.2) ** 2
    envelope = torch.sigmoid((1.0 - r2) * 8.0)
    tissue = _blobs(gen, x, n_blobs=12)
    folds = _blobs(gen, x, n_blobs=24, sigma_rng=(0.15, 0.35))
    img = envelope * (0.55 * tissue + 0.45 * folds)
    return img / torch.clamp(torch.max(img), min=1e-6)


def random_velocity(gen: torch.Generator, shape, amplitude: float = 0.6,
                    sigma_vox: float = 3.0, device="cpu") -> torch.Tensor:
    """Smooth random stationary velocity: white noise -> spectral Gaussian
    smoothing -> max |v| = amplitude (physical units)."""
    v = torch.randn((3,) + tuple(shape), generator=gen, dtype=torch.float32)
    v = v.to(device)
    v = _spec.gauss_smooth(v, sigma_vox * shape[0] / 64.0 if shape[0] >= 64 else sigma_vox)
    vmax = torch.max(torch.sqrt(torch.sum(v * v, dim=0)))
    return (amplitude / torch.clamp(vmax, min=1e-6)) * v


def _make_pair(gen: torch.Generator, shape, amplitude: float, nt: int,
               dev: torch.device) -> ImagePair:
    shape = tuple(int(n) for n in shape)
    m0 = brain_phantom(gen, shape, device=dev)
    v_true = random_velocity(gen, shape, amplitude=amplitude, device=dev)
    cfg = _tr.TransportConfig(interp="cubic_bspline", deriv="fd8", nt=nt)
    m1 = _tr.solve_state(m0, v_true, cfg)[-1]
    return ImagePair(m0=m0, m1=m1, labels0=(m0 > 0.35).to(torch.float32),
                     labels1=(m1 > 0.35).to(torch.float32), v_true=v_true)


def make_pair(seed: int, shape: Tuple[int, int, int], amplitude: float = 0.6,
              nt: int = 4, device="cuda") -> ImagePair:
    """A registration problem (m0, m1 = m0 transported by v_true) + labels."""
    dev = _device.resolve(device)
    return _make_pair(torch.Generator().manual_seed(int(seed)), shape, amplitude, nt, dev)


def multimodal_remap(m1: torch.Tensor, mode: str = "inverted") -> torch.Tensor:
    """The reference's intensity mapping of :func:`make_multimodal_pair`:
    ``"inverted"`` 1 - m1, ``"quadratic"`` (1 - m1)^2."""
    if mode == "inverted":
        return 1.0 - m1
    if mode == "quadratic":
        return (1.0 - m1) ** 2
    raise ValueError(f"unknown multimodal mode {mode!r}; "
                     "expected 'inverted' or 'quadratic'")


def make_multimodal_pair(seed: int, shape: Tuple[int, int, int], amplitude: float = 0.6,
                         nt: int = 4, mode: str = "inverted", device="cuda") -> ImagePair:
    """A contrast-changed problem (the multi-modal scenario): the geometry of
    :func:`make_pair` with the reference's intensities remapped
    (:func:`multimodal_remap`). The labels stay geometric (thresholds of the
    images before the remap), so Dice stays a quality metric; SSD cannot
    register these pairs, NCC takes ``"inverted"``, NGF both."""
    pair = make_pair(seed, shape, amplitude=amplitude, nt=nt, device=device)
    return dataclasses.replace(pair, m1=multimodal_remap(pair.m1, mode))


def make_batch(seed: int, shape: Tuple[int, int, int], batch: int, amplitude: float = 0.6,
               nt: int = 4, device="cuda") -> ImagePair:
    """Batch of independent pairs (the population-study workload), stacked
    on a leading axis. The pairs are drawn one after another from one
    ``torch.Generator(seed)``, so pair 0 is ``make_pair(seed)``."""
    dev = _device.resolve(device)
    gen = torch.Generator().manual_seed(int(seed))
    pairs = [_make_pair(gen, shape, amplitude, nt, dev) for _ in range(int(batch))]
    return ImagePair(*(torch.stack([getattr(p, f.name) for p in pairs])
                       for f in dataclasses.fields(ImagePair)))

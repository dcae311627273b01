"""Problem description for the registration facade (port of
``repro.api.problem``).

A :class:`RegistrationProblem` bundles the template and reference images
(numpy arrays or tensors) and optional label masks for Dice, and knows
whether it is a single pair ``(N1, N2, N3)`` or a batch ``(B, N1, N2, N3)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class RegistrationProblem:
    """One registration task: transport ``m0`` onto ``m1``.

    Arrays are either a single pair (3D) or a batch with a leading axis (4D);
    ``m0`` and ``m1`` must agree in shape. Optional label masks enable Dice
    reporting in the result.
    """

    m0: object
    m1: object
    labels0: Optional[object] = None
    labels1: Optional[object] = None
    name: str = "problem"

    def __post_init__(self):
        if tuple(self.m0.shape) != tuple(self.m1.shape):
            raise ValueError(f"m0 {tuple(self.m0.shape)} and m1 {tuple(self.m1.shape)} "
                             "shapes differ")
        if self.m0.ndim not in (3, 4):
            raise ValueError(f"expected (N1,N2,N3) or (B,N1,N2,N3), got "
                             f"{tuple(self.m0.shape)}")
        for lbl, nm in ((self.labels0, "labels0"), (self.labels1, "labels1")):
            if lbl is not None and tuple(lbl.shape) != tuple(self.m0.shape):
                raise ValueError(f"{nm} shape {tuple(lbl.shape)} != image "
                                 f"{tuple(self.m0.shape)}")

    @property
    def is_batched(self) -> bool:
        return self.m0.ndim == 4

    @property
    def batch_size(self) -> Optional[int]:
        return int(self.m0.shape[0]) if self.is_batched else None

    @property
    def grid(self) -> Tuple[int, int, int]:
        return tuple(int(n) for n in self.m0.shape[-3:])

    @classmethod
    def synthetic(cls, seed: int = 0, grid: Tuple[int, int, int] = (32, 32, 32),
                  amplitude: float = 0.5, batch: Optional[int] = None,
                  name: Optional[str] = None, device="cuda") -> "RegistrationProblem":
        """Synthetic brain-phantom pair(s) on ``device``
        (``repro_torch.data.synthetic.make_pair`` / ``make_batch``)."""
        from ..data import synthetic as _syn

        if batch is None:
            p = _syn.make_pair(seed, grid, amplitude=amplitude, device=device)
        else:
            p = _syn.make_batch(seed, grid, batch, amplitude=amplitude, device=device)
        return cls(m0=p.m0, m1=p.m1, labels0=p.labels0, labels1=p.labels1,
                   name=name or f"synthetic-{seed}-{'x'.join(map(str, grid))}"
                   + (f"-b{batch}" if batch else ""))

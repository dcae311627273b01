"""Fault-tolerant training loop (port of ``repro.train.trainer``).

  * checkpoint / restart: async atomic checkpoints every ``ckpt_every``
    steps in the JAX package's disk format (either package restores the
    other's train state), and a restore from the latest step at start-up;
  * preemption: SIGTERM makes the loop checkpoint at the end of the current
    step and stop;
  * stragglers: a wall-time EMA of the steps; a step slower than
    ``straggler_factor`` x the EMA is counted and logged;
  * data: host-side double-buffered prefetch.

Sharded training waits for ROADMAP A20.4: the trainer runs on the model's
device, and a mesh of more than one device raises.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..data.tokens import Prefetcher
from ..optim.adamw import AdamWConfig
from . import steps as tsteps


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    log_every: int = 10
    straggler_factor: float = 1.5
    ema_alpha: float = 0.1
    opt: AdamWConfig = field(default_factory=AdamWConfig)


class Trainer:
    def __init__(self, model, mesh, cfg: TrainerConfig):
        self.model = model
        self.cfg = cfg
        self.step_fn = tsteps.make_train_step(model, mesh, cfg.opt)
        self.state: Optional[tsteps.TrainState] = None
        self.start_step = 0
        self.ckpt = (AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.ckpt_keep)
                     if cfg.ckpt_dir else None)
        self._preempted = False
        self.metrics_log: List[Dict[str, float]] = []
        self.straggler_steps = 0
        self._ema: Optional[float] = None

    # ------------------------------------------------------------------
    def init_or_restore(self, generator: Optional[torch.Generator] = None):
        """The latest checkpoint under ``ckpt_dir`` on the model's device, or
        a fresh state with weights from ``generator``."""
        if self.cfg.ckpt_dir and latest_step(self.cfg.ckpt_dir) is not None:
            abstract = tsteps.abstract_train_state(self.model)
            self.state = restore_checkpoint(self.cfg.ckpt_dir, abstract,
                                            device=self.model.dev)
            self.start_step = int(self.state.opt["step"])
            print(f"[trainer] restored step {self.start_step} "
                  f"from {self.cfg.ckpt_dir}")
        else:
            self.state = tsteps.init_train_state(self.model, generator, self.cfg.opt)
            self.start_step = 0

    # ------------------------------------------------------------------
    def _on_sigterm(self, *_):
        self._preempted = True
        print("[trainer] SIGTERM received: checkpointing at end of step")

    def run(self, batches: Iterator, generator: Optional[torch.Generator] = None,
            prefetch: bool = True):
        if self.state is None:
            self.init_or_restore(generator)
        old_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
        it = iter(Prefetcher(batches)) if prefetch else iter(batches)
        step = self.start_step
        try:
            while step < self.cfg.total_steps:
                batch = next(it)
                t0 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, batch)
                float(metrics["loss"])  # waits for the step's device work
                dt = time.perf_counter() - t0
                step += 1

                if self._ema is None:
                    self._ema = dt
                elif dt > self.cfg.straggler_factor * self._ema:
                    self.straggler_steps += 1
                    print(f"[trainer] straggler step {step}: {dt:.3f}s "
                          f"(EMA {self._ema:.3f}s)")
                self._ema = ((1 - self.cfg.ema_alpha) * self._ema
                             + self.cfg.ema_alpha * dt)

                if step % self.cfg.log_every == 0 or step == self.cfg.total_steps:
                    rec = {k: float(v) for k, v in metrics.items()}
                    rec.update(step=step, step_time_s=dt)
                    self.metrics_log.append(rec)
                    print(f"[trainer] step {step} loss={rec['loss']:.4f} "
                          f"gnorm={rec.get('grad_norm', 0):.3f} {dt:.3f}s")

                if self.ckpt and (step % self.cfg.ckpt_every == 0):
                    self.ckpt.save(self.state, step)
                if self._preempted:
                    if self.ckpt:
                        self.ckpt.wait()
                        self.ckpt.save(self.state, step)
                        self.ckpt.wait()
                    print(f"[trainer] preemption checkpoint at step {step}")
                    break
        finally:
            signal.signal(signal.SIGTERM, old_handler)
            if self.ckpt:
                self.ckpt.wait()
        return self.state

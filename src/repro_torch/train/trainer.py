"""Fault-tolerant training loop (port of ``repro.train.trainer``).

  * checkpoint / restart: async atomic checkpoints every ``ckpt_every``
    steps in the JAX package's disk format (either package restores the
    other's train state), and a restore from the latest step at start-up;
  * preemption: SIGTERM makes the loop checkpoint at the end of the current
    step and stop;
  * stragglers: a wall-time EMA of the steps; a step slower than
    ``straggler_factor`` x the EMA is counted and logged;
  * data: host-side double-buffered prefetch;
  * meshes: each rank keeps its blocks of the state (``steps.state_specs``
    on ``steps.resolve_mesh``; one device holds the whole state). With
    ranks (``repro_torch.launch.mesh``) a fresh state is
    drawn whole from the seeded generator and sliced, so a sharded run
    starts from the single-device state; a checkpoint gathers the full
    leaves, rank 0 writes them and every rank waits for the write; a
    restore reads the full leaves and slices them, so any mesh restores any
    checkpoint; a SIGTERM on any rank makes every rank checkpoint at the
    same step. Only rank 0 prints.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

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
        self.mesh = tsteps.resolve_mesh(mesh)
        self.step_fn = tsteps.make_train_step(model, self.mesh, cfg.opt)
        self.specs = tsteps.state_specs(model, self.mesh)
        #: whether the mesh has ranks, whose collectives the loop joins
        self.world = not self.mesh.abstract
        self.rank0 = not self.world or dist.get_rank() == 0
        self.state: Optional[tsteps.TrainState] = None
        self.start_step = 0
        self.ckpt = (AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.ckpt_keep)
                     if cfg.ckpt_dir and self.rank0 else None)
        self._preempted = False
        self.metrics_log: List[Dict[str, float]] = []
        self.straggler_steps = 0
        self._ema: Optional[float] = None

    # ------------------------------------------------------------------
    def _log(self, msg: str):
        if self.rank0:
            print(msg)

    def init_or_restore(self, generator: Optional[torch.Generator] = None):
        """The latest checkpoint under ``ckpt_dir`` on the model's device, or
        a fresh state with weights from ``generator``; this rank's blocks
        of either."""
        if self.cfg.ckpt_dir and latest_step(self.cfg.ckpt_dir) is not None:
            abstract = tsteps.abstract_train_state(self.model)
            state = restore_checkpoint(self.cfg.ckpt_dir, abstract, device=self.model.dev)
            self.start_step = int(state.opt["step"])
            self._log(f"[trainer] restored step {self.start_step} "
                      f"from {self.cfg.ckpt_dir}")
        else:
            state = tsteps.init_train_state(self.model, generator, self.cfg.opt)
            self.start_step = 0
        self.state = tsteps.shard_state(state, self.specs, self.mesh)

    def full_state(self) -> tsteps.TrainState:
        """The whole train state (with ranks: gathered from every rank, a
        collective)."""
        return tsteps.gather_state(self.state, self.specs, self.mesh)

    def _save(self, step: int, wait: bool):
        state = self.full_state()
        if self.ckpt:
            self.ckpt.save(state, step)
            if wait or self.world:
                self.ckpt.wait()
        if self.world:
            dist.barrier()

    def _any_preempted(self) -> bool:
        """Whether any rank has seen a SIGTERM (a max over the world)."""
        if not self.world:
            return self._preempted
        flag = torch.tensor([int(self._preempted)], device=self.model.dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

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
                    self._log(f"[trainer] straggler step {step}: {dt:.3f}s "
                              f"(EMA {self._ema:.3f}s)")
                self._ema = ((1 - self.cfg.ema_alpha) * self._ema
                             + self.cfg.ema_alpha * dt)

                if step % self.cfg.log_every == 0 or step == self.cfg.total_steps:
                    rec = {k: float(v) for k, v in metrics.items()}
                    rec.update(step=step, step_time_s=dt)
                    self.metrics_log.append(rec)
                    self._log(f"[trainer] step {step} loss={rec['loss']:.4f} "
                              f"gnorm={rec.get('grad_norm', 0):.3f} {dt:.3f}s")

                if self.cfg.ckpt_dir and (step % self.cfg.ckpt_every == 0):
                    self._save(step, wait=False)
                if self._any_preempted():
                    self._preempted = True
                    if self.cfg.ckpt_dir:
                        self._save(step, wait=True)
                    self._log(f"[trainer] preemption checkpoint at step {step}")
                    break
        finally:
            signal.signal(signal.SIGTERM, old_handler)
            if self.ckpt:
                self.ckpt.wait()
        return self.state

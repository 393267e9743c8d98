"""Fault-tolerant trainer on one device.

Port of ``repro/train/trainer.py``.  The loop:
  * a train step (forward, backward, AdamW update in place) on the
    trainer's device;
  * self-scheduled shard ingestion (:mod:`repro_torch.data`) feeds
    fixed-shape batches;
  * async checkpoints every ``ckpt_every`` steps, auto-resume;
  * re-mesh: commit a sync checkpoint, rebuild, restore onto the given
    device and continue — the one-card collapse of the reference's
    survivor re-mesh (its multi-device mesh and shardings wait with the
    mesh tools);
  * straggler watchdog: per-step wall time EWMA; steps slower than
    ``straggler_factor`` x EWMA are counted and reported.

Where the reference takes a ``Mesh`` the port takes ``device=`` (default:
the card; it raises without one unless told ``"cpu"``).  The
reference's parameters come from ``jax.random.key(seed)`` and the port's
from a ``torch.Generator`` seeded alike, so a fresh run starts from
other values; a run resumed from a checkpoint of either package
continues from the same ones.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.launch import steps as step_lib
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import (
    OptimizerConfig, apply_updates, init_opt_state)
from repro_torch.train.schedules import get_schedule


@dataclasses.dataclass
class TrainerConfig:
    workdir: str
    total_steps: int = 100
    ckpt_every: int = 20
    keep_ckpts: int = 3
    log_every: int = 10
    schedule: str = "cosine"
    peak_lr: float = 3e-4
    warmup_steps: int = 10
    straggler_factor: float = 3.0
    remat: bool = True


class Trainer:
    def __init__(self, cfg: ArchConfig, opt_cfg: OptimizerConfig,
                 tcfg: TrainerConfig, device=None, seed: int = 0):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.device = ops.resolve_device(device)
        self.seed = seed
        self.step = 0
        self.metrics_log: list[dict] = []
        self.straggler_steps = 0
        self._ewma: Optional[float] = None
        os.makedirs(tcfg.workdir, exist_ok=True)
        self.ckpt_dir = os.path.join(tcfg.workdir, "ckpt")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.async_ckpt = ckpt_lib.AsyncCheckpointer(
            self.ckpt_dir, keep=tcfg.keep_ckpts)
        self.schedule = get_schedule(
            tcfg.schedule, peak=tcfg.peak_lr,
            warmup_steps=tcfg.warmup_steps, total_steps=tcfg.total_steps)
        self._build(restore=True)

    # -- construction / restore -------------------------------------------

    def _build(self, restore: bool) -> None:
        cfg = self.cfg
        restored = None
        if restore:
            template = {"params": step_lib.param_specs(cfg),
                        "opt": step_lib.opt_state_specs(cfg, self.opt_cfg)}
            restored, step = ckpt_lib.restore_latest(
                self.ckpt_dir, template, self.device)
            if restored is not None:
                self.step = step + 1
        if restored is not None:
            self.params = restored["params"]
            self.opt_state = restored["opt"]
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self.params = M.init_params(cfg, gen, self.device)
            self.opt_state = init_opt_state(self.params, self.opt_cfg)

        def train_step(params, opt_state, batch, step):
            lr = self.schedule(step)
            loss, grads = step_lib.value_and_grad(
                cfg, params, batch, remat=self.tcfg.remat)
            params, opt_state, metrics = apply_updates(
                params, grads, opt_state, self.opt_cfg, lr=lr)
            metrics.update(loss=loss, lr=lr)
            return params, opt_state, metrics

        self._step_fn = train_step

    # -- re-mesh -----------------------------------------------------------

    def remesh(self, device) -> None:
        """Sync-commit, rebuild and restore onto ``device``, continue."""
        self.async_ckpt.wait()
        ckpt_lib.save(self.ckpt_dir, self.step,
                      {"params": self.params, "opt": self.opt_state},
                      keep=self.tcfg.keep_ckpts)
        self.step += 1           # restored checkpoint resumes after itself
        self.device = ops.resolve_device(device)
        self._build(restore=True)

    # -- loop ------------------------------------------------------------------

    def run(self, batches: Iterator[dict[str, np.ndarray]],
            n_steps: Optional[int] = None) -> list[dict]:
        """Up to ``n_steps`` steps (default ``total_steps``) from
        ``batches`` (numpy arrays or tensors).  One host sync a step:
        the loss and grad norm come back together."""
        n_steps = n_steps or self.tcfg.total_steps
        target = self.step + n_steps
        for batch in batches:
            if self.step >= target:
                break
            dev_batch = {k: torch.as_tensor(v).to(self.device)
                         for k, v in batch.items()}
            t0 = time.monotonic()
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, dev_batch, self.step)
            loss, gnorm = torch.stack(
                [metrics["loss"].float(), metrics["grad_norm"]]).tolist()
            dt = time.monotonic() - t0
            # straggler watchdog
            if self._ewma is not None and \
                    dt > self.tcfg.straggler_factor * self._ewma:
                self.straggler_steps += 1
            self._ewma = dt if self._ewma is None else \
                0.9 * self._ewma + 0.1 * dt
            rec = {"step": self.step, "loss": loss, "grad_norm": gnorm,
                   "lr": float(metrics["lr"]), "sec": dt}
            self.metrics_log.append(rec)
            if self.step % self.tcfg.log_every == 0:
                print(f"step {self.step:5d} loss {loss:.4f} "
                      f"gnorm {rec['grad_norm']:.3f} {dt*1e3:.0f}ms",
                      flush=True)
            if self.tcfg.ckpt_every and \
                    self.step % self.tcfg.ckpt_every == 0 and \
                    self.step > 0:
                self.async_ckpt.save_async(
                    self.step,
                    {"params": self.params, "opt": self.opt_state})
            self.step += 1
        return self.metrics_log

    def close(self) -> None:
        self.async_ckpt.close()

"""Fault-tolerant, elastic trainer, on one device or a device mesh.

Port of ``repro/train/trainer.py``.  The loop:
  * a train step (forward, backward, AdamW update in place) on the
    trainer's device, or on a ``DeviceMesh`` with parameters, moments
    and batches as DTensors placed by the ``distribution.sharding``
    rules (FSDP over 'data', TP over 'model', DP over 'pod');
  * self-scheduled shard ingestion (:mod:`repro_torch.data`) feeds
    fixed-shape batches (every rank of a mesh feeds the same global
    batch, which is then sharded);
  * async checkpoints every ``ckpt_every`` steps, auto-resume; a
    checkpoint holds whole tensors, so it restores onto a device or any
    mesh.  On a mesh, parameters are drawn, restored, placed and saved
    one leaf at a time: one whole leaf (or one sublayer's draw) at most
    is on a device beside the shards; the async save's host copy holds
    the whole tree on rank 0's host alone;
  * elastic re-mesh: commit a sync checkpoint, rebuild on the survivors'
    mesh (or device), restore, re-shard and continue — the training-loop
    analogue of the paper's manager re-queueing a dead worker's tasks; a
    rank outside the new mesh drops out (its ``run`` does nothing);
  * straggler watchdog: per-step wall time EWMA; steps slower than
    ``straggler_factor`` x EWMA are counted and reported.

``mesh=None`` trains on ``device`` (default: the card; it raises
without one unless told ``"cpu"``); a mesh must hold rank 0, which
writes the checkpoints.  The reference's parameters come from
``jax.random.key(seed)`` and the port's
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
from torch.distributed.tensor import zeros as dtensor_zeros

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.launch import steps as step_lib
from repro_torch.models import model as M
from repro_torch.models.layers import is_dtensor
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.distribution.sharding import (
    batch_shardings, distribute, opt_state_shardings, param_shardings,
    tree_map_shardings)
from repro_torch.launch.mesh import mesh_context
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
                 tcfg: TrainerConfig, mesh=None, device=None,
                 seed: int = 0):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self._set_mesh(mesh, device)
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

    def _set_mesh(self, mesh, device) -> None:
        """The mesh (or None) and the device this rank computes on."""
        self.mesh = mesh
        if mesh is None:
            self.device = ops.resolve_device(device)
            self.active = True
            return
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda" else
                       torch.device(mesh.device_type))
        # A rank outside the mesh (a worker lost to a re-mesh) drops out.
        self.active = mesh.get_coordinate() is not None

    def _build(self, restore: bool) -> None:
        cfg = self.cfg
        pspecs = step_lib.param_specs(cfg)
        ospecs = step_lib.opt_state_specs(cfg, self.opt_cfg)
        if self.mesh is not None:
            self.psh = param_shardings(pspecs, self.mesh)
            self.osh = opt_state_shardings(ospecs, pspecs, self.psh,
                                           self.mesh)
        # With a mesh every leaf is placed as it is drawn or read: one
        # whole leaf at most is on the device beside the shards.
        shardings = (None if self.mesh is None
                     else {"params": self.psh, "opt": self.osh})
        restored = None
        if restore:
            template = {"params": pspecs, "opt": ospecs}
            restored, step = ckpt_lib.restore_latest(
                self.ckpt_dir, template, self.device, shardings)
            if restored is not None:
                self.step = step + 1
        if restored is not None:
            self.params = restored["params"]
            self.opt_state = restored["opt"]
        elif self.mesh is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self.params = M.init_params(cfg, gen, self.device)
            self.opt_state = init_opt_state(self.params, self.opt_cfg)
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self.params = M.init_params(cfg, gen, self.device, self.psh)
            # init_opt_state's zero moments and count, shard by shard
            self.opt_state = tree_map_shardings(
                lambda spec, sh: dtensor_zeros(
                    tuple(spec.shape), dtype=spec.dtype,
                    device_mesh=sh.mesh, placements=sh.placements),
                ospecs, self.osh)

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

    def remesh(self, new_mesh) -> None:
        """Survivor re-mesh: sync-commit, rebuild on ``new_mesh`` (a
        ``DeviceMesh``, or a device for one device), restore, re-shard,
        continue.  Every rank of the old mesh calls it; a rank outside
        the new mesh drops out.  The argument keeps the reference's name,
        so ``remesh(new_mesh=...)`` works as the reference's does."""
        from torch.distributed.device_mesh import DeviceMesh
        self.async_ckpt.wait()
        ckpt_lib.save(self.ckpt_dir, self.step,
                      {"params": self.params, "opt": self.opt_state},
                      keep=self.tcfg.keep_ckpts)
        if self.mesh is not None:
            _mesh_barrier(self.mesh)         # rank 0's commit is on disk
        self.step += 1           # restored checkpoint resumes after itself
        if isinstance(new_mesh, DeviceMesh):
            self._set_mesh(new_mesh, None)
        else:
            self._set_mesh(None, new_mesh)
        if self.active:
            self._build(restore=True)
        else:
            self.params = self.opt_state = None

    # -- loop ------------------------------------------------------------------

    def run(self, batches: Iterator[dict[str, np.ndarray]],
            n_steps: Optional[int] = None) -> list[dict]:
        """Up to ``n_steps`` steps (default ``total_steps``) from
        ``batches`` (numpy arrays or tensors).  One host sync a step:
        the loss and grad norm come back together."""
        n_steps = n_steps or self.tcfg.total_steps
        target = self.step + n_steps
        if not self.active:
            return self.metrics_log
        for batch in batches:
            if self.step >= target:
                break
            dev_batch = {k: torch.as_tensor(v).to(self.device)
                         for k, v in batch.items()}
            t0 = time.monotonic()
            if self.mesh is None:
                self.params, self.opt_state, metrics = self._step_fn(
                    self.params, self.opt_state, dev_batch, self.step)
            else:
                dev_batch = tree_map_shardings(
                    distribute, dev_batch,
                    batch_shardings(self.mesh, dev_batch))
                with mesh_context(self.mesh):
                    self.params, self.opt_state, metrics = self._step_fn(
                        self.params, self.opt_state, dev_batch, self.step)
                metrics = {k: _whole(v) for k, v in metrics.items()}
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


def _mesh_barrier(mesh) -> None:
    """Return once every rank of ``mesh`` has entered: an all-reduce
    over each mesh dim in turn carries every rank's arrival to all."""
    t = torch.ones(1, device=mesh.device_type)
    for i in range(mesh.ndim):
        torch.distributed.all_reduce(t, group=mesh.get_group(i))


def _whole(x):
    return x.full_tensor() if is_dtensor(x) else x

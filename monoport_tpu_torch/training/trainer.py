"""Trainer — the optimisation loop with checkpoints and resume (port of
``monoport_tpu/training/trainer.py``).

Builds the optimizer by config name (``parallel.train_step.make_optimizer``:
optax's rules, the MultiStepLR milestones converted from epochs to steps),
the colour logger and, when tensorboardX imports, a summary writer. The
checkpoint is one ``torch.save`` dict of tensors, ints and the config as
plain dicts: ``params`` (the module's ``state_dict``, BatchNorm running
stats included), ``opt_state`` (slot -> parameter name -> tensor),
``step``, ``epoch``, ``iteration`` and ``opt``; it loads with
``torch.load(weights_only=True)``. ``cfg.resume`` also restores the
optimizer state, step, epoch and iteration. The loss is read on the host
only every ``cfg.freq_plot`` steps.

Data parallel: with ``use_mesh`` in a world of several ranks (an
initialized process group, one process a rank, e.g. under ``torchrun``)
the Trainer makes the JAX Trainer's (data, points) mesh (``mesh_shape``)
and the step takes the global batch (``parallel/train_step``); the device
``cuda`` is this rank's card (``parallel.mesh.rank_device``). Rank 0 alone
logs, writes tensorboard and saves checkpoints; every rank loads one. A
rank that the mesh leaves out (the dp-only mesh of the JAX Trainer, which
leaves devices idle too) takes part in no collective and runs no step,
and says so.
"""

from __future__ import annotations

import logging
import os
from typing import Iterable, Optional

import numpy as np
import torch

from ..models.monoport_net import eval_net
from ..parallel.mesh import make_mesh, rank_device, world
from ..parallel.train_step import (TrainState, create_train_state,
                                   make_optimizer, make_train_step)
from ..weights import _as_state, resolve_device
from .logger import colorlogger


def to_device(batch: dict, device: torch.device) -> dict:
    """A batch of numpy arrays or tensors as f32 tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device=device, dtype=torch.float32)
            for k, v in batch.items()}


def mesh_shape(world_size: int, batch_size: int,
               num_sample_geo: int) -> Optional[tuple[int, int]]:
    """The JAX Trainer's (dp, sp) choice for ``world_size`` ranks, or None
    (no mesh): dp, the largest power of two dividing both the batch and
    the world; sp, the rest of the world where it divides the point count;
    else a dp-only mesh of dp ranks, which leaves the others out."""
    if world_size <= 1:
        return None
    dp = 1
    while (dp * 2 <= world_size and batch_size % (dp * 2) == 0
           and world_size % (dp * 2) == 0):
        dp *= 2
    sp = world_size // dp
    if num_sample_geo % sp == 0:
        return dp, sp
    if dp > 1:
        return dp, 1
    return None


class Trainer:
    def __init__(self, net, cfg, use_mesh: bool = True,
                 steps_per_epoch: int = 1000, device=None):
        self.rank, world_size = world()
        self.device = rank_device(resolve_device(device))
        shape = (mesh_shape(world_size, cfg.batch_size,
                            cfg.dataset.num_sample_geo) if use_mesh
                 else None)
        # every rank makes the mesh: its process groups are made together
        self.mesh = (make_mesh(n_devices=shape[0] * shape[1], dp=shape[0])
                     if shape else None)
        self.net = net.to(self.device)
        self.cfg = cfg
        self.epoch = 0
        self.iteration = 0

        self.checkpoints_path = os.path.join(cfg.checkpoints_path, cfg.name)
        self.results_path = os.path.join(cfg.results_path, cfg.name)
        self.tb_writer = None
        if self.rank == 0:
            os.makedirs(self.checkpoints_path, exist_ok=True)
            os.makedirs(self.results_path, exist_ok=True)
            self.logger = colorlogger(self.results_path)
            try:
                from tensorboardX import SummaryWriter
                self.tb_writer = SummaryWriter(logdir=self.results_path)
            except ImportError:
                pass
        else:
            # warnings only: rank 0 logs the run
            self.logger = logging.getLogger(
                f"monoport_tpu_torch.trainer.rank{self.rank}")
        if self.mesh is not None:
            self.logger.info("data parallel over a %s mesh of %d ranks",
                             self.mesh.shape, world_size)
            if not self.mesh.active:
                self.logger.warning(
                    "rank %d is outside the %s mesh: it runs no step",
                    self.rank, self.mesh.shape)

        # the reference's MultiStepLR milestones are epochs
        milestones = [int(m) * steps_per_epoch for m in cfg.schedule]
        self.tx = make_optimizer(cfg.optim, cfg.learning_rate,
                                 cfg.weight_decay, cfg.momentum,
                                 tuple(milestones), cfg.gamma,
                                 grad_clip=cfg.get("grad_clip", 0.0))
        self.step_fn = make_train_step(self.net, self.mesh)
        self.state: Optional[TrainState] = None

    # -- state --------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """Fresh weights (``init_params``) from ``generator``, default a
        CPU generator seeded 0."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.state = create_train_state(self.net, self.tx, generator,
                                        self.mesh)
        return self.state

    def load_params(self, variables) -> None:
        """Adopt external weights: flax variables (``weights.load_params``)
        or a port ``state_dict`` (``convert.load_legacy_pifu``)."""
        if self.state is None:
            raise RuntimeError("call init_state first")
        self.net.load_state_dict(_as_state(variables), strict=True)

    # -- checkpoints --------------------------------------------------------
    def _names(self) -> list[str]:
        return [n for n, _ in self.net.named_parameters()]

    def update_ckpt(self, filename: str, epoch: int, iteration: int,
                    **kwargs) -> None:
        """Rank 0 saves; the other ranks hold the same state."""
        if self.rank != 0:
            return
        path = os.path.abspath(os.path.join(self.checkpoints_path, filename))
        names = self._names()
        ckpt = {
            "params": self.net.state_dict(),
            "opt_state": {slot: dict(zip(names, tensors))
                          for slot, tensors in self.state.opt_state.items()},
            "step": self.state.step,
            "epoch": int(epoch),
            "iteration": int(iteration),
            "opt": self.cfg.to_dict(),
            **kwargs,
        }
        torch.save(ckpt, path)
        self.logger.info("saving ckpt to %s", path)

    def load_ckpt(self, path: str) -> None:
        path = os.path.abspath(path)
        self.logger.info("loading ckpt from %s", path)
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.net.load_state_dict(ckpt["params"], strict=True)
        if self.cfg.resume:
            self.logger.info("resume training with optimizer state")
            names = self._names()
            if set(ckpt["opt_state"]) != set(self.state.opt_state):
                raise KeyError(f"the checkpoint's optimizer slots "
                               f"{sorted(ckpt['opt_state'])} are not this "
                               f"optimizer's {sorted(self.state.opt_state)}")
            with torch.no_grad():
                for slot, tensors in self.state.opt_state.items():
                    for name, t in zip(names, tensors):
                        t.copy_(ckpt["opt_state"][slot][name])
            self.state.step = int(ckpt["step"])
            self.epoch = int(ckpt["epoch"])
            self.iteration = int(ckpt["iteration"])

    # -- evaluation ---------------------------------------------------------
    def evaluate(self, eval_batch: dict) -> dict:
        """Occupancy metrics with the net in eval mode (BatchNorm on its
        running stats), then back to train mode."""
        from .metrics import evaluate_occupancy

        metrics = evaluate_occupancy(eval_net(self.net),
                                     to_device(eval_batch, self.device))
        self.net.train()
        self.logger.info("eval iter %d: %s", self.iteration, metrics)
        if self.tb_writer is not None:
            for k, v in metrics.items():
                self.tb_writer.add_scalar(f"eval/{k}", v, self.iteration)
        return metrics

    # -- loop ---------------------------------------------------------------
    def train_epoch(self, batches: Iterable[dict], epoch: int,
                    eval_batch: Optional[dict] = None) -> float:
        if self.mesh is not None and not self.mesh.active:
            return float("nan")
        losses = []
        for batch in batches:
            if self.state is None:
                self.init_state()
            self.state, loss = self.step_fn(
                self.state, to_device(batch, self.device))
            self.iteration += 1
            if self.iteration % self.cfg.freq_plot == 0:
                lossf = float(loss)
                losses.append(lossf)
                self.logger.info("epoch %d iter %d loss %.5f",
                                 epoch, self.iteration, lossf)
                if self.tb_writer is not None:
                    self.tb_writer.add_scalar("train/loss", lossf,
                                              self.iteration)
            if self.iteration % self.cfg.freq_save == 0:
                self.update_ckpt(f"ckpt_{self.iteration}", epoch,
                                 self.iteration)
            if (eval_batch is not None
                    and self.iteration % self.cfg.freq_eval == 0):
                self.evaluate(eval_batch)
        self.epoch = epoch
        return float(np.mean(losses)) if losses else float("nan")

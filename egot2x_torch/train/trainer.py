"""Trainer: the fit loop, validation and checkpoints.

Counterpart of ``egot2x/train/trainer.py`` on one card:

  * before the first step, a model whose int8 activation scales are still
    0 is calibrated on the first train batch (static PTQ needs
    representative activations);
  * each epoch runs the task's ``train_step`` over the train loader, its
    dropout masks drawn from one ``torch.Generator`` seeded from
    ``seed``, then validates and saves a checkpoint;
  * :class:`CheckpointManager` keeps the top k epochs by the task's
    checkpoint metric plus the last one (the epoch just saved is never
    pruned), in the port's format (``core/checkpoint.py``): the model's
    weights and buffers (BN running statistics, int8 scales), the
    optimizer and a learning-rate scheduler the state holds (the task's
    train step steps it);
  * ``fit(resume_from=...)`` restores the last checkpoint of a directory
    and goes on at the next epoch; ``fast_dev_run`` runs one train batch
    and one validation batch and saves nothing;
  * ``precise_bn_batches`` N > 0 recomputes the BN running statistics over
    N train batches before each validation (``train/precise_bn.py``;
    the reference's BN.USE_PRECISE_STATS), for tasks that give
    ``bn_forward_args``.

Loaders are any iterables of dict batches (numpy arrays or tensors;
other values, such as segment ids, stay on the host for the task's
``accumulate``), or of ``{task: batch}`` dicts of them, as
``data/combined.py::CombinedLoader`` yields for the multi-task tasks: the
tasks' own ``train_loader()`` and ``val_loader()`` (``data/``), whose
items the data plane builds on the card already. The Trainer runs on the
card unless ``device`` says otherwise, and raises when the task's model is
elsewhere. Data-parallel training (the JAX package's mesh) is not ported:
one process, one card.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from egot2x_torch.core.checkpoint import (epoch_path, last_epoch,
                                          load_checkpoint)
from egot2x_torch.core.registry import resolve_device
from egot2x_torch.nn.quant import scale_buffers
from egot2x_torch.train.precise_bn import compute_precise_bn_stats
from egot2x_torch.tasks.base import Task

logger = logging.getLogger(__name__)


class CheckpointManager:
    """Top-k + last checkpoints keyed on a metric."""

    def __init__(self, directory: str, metric: str, mode: str = "max",
                 top_k: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.metric, self.mode, self.top_k = metric, mode, top_k
        self._scores: Dict[int, float] = {}

    def save(self, state, epoch: int, metrics: Dict[str, float]) -> None:
        torch.save(state.state_dict(), epoch_path(self.directory, epoch))
        self._scores[epoch] = float(metrics.get(self.metric, 0.0))
        with open(os.path.join(self.directory,
                               f"epoch_{epoch}.metrics.json"), "w") as f:
            json.dump(metrics, f)
        ranked = sorted(self._scores, key=self._scores.get,
                        reverse=self.mode == "max")
        for stale in ranked[self.top_k:]:
            if stale == epoch:   # 'last' points at it
                continue
            del self._scores[stale]
            os.remove(epoch_path(self.directory, stale))
        with open(os.path.join(self.directory, "last.json"), "w") as f:
            json.dump({"epoch": epoch, "metrics": metrics}, f)

    def restore(self, state, epoch: Optional[int] = None):
        if epoch is None:
            epoch = last_epoch(self.directory)
        return state.load_state_dict(
            load_checkpoint(epoch_path(self.directory, epoch)))


def _uncalibrated(model: torch.nn.Module) -> bool:
    return any(float(b) <= 0.0 for _, b in scale_buffers(model))


class Trainer:
    def __init__(self, task: Task, max_epochs: int = 1,
                 fast_dev_run: bool = False, default_root_dir: str = "logs",
                 log_every: int = 10, seed: int = 0, device=None,
                 precise_bn_batches: int = 0):
        self.task = task
        self.max_epochs = max_epochs
        self.fast_dev_run = fast_dev_run
        self.root = default_root_dir
        self.log_every = log_every
        self.seed = seed
        self.device = resolve_device(device)
        self.precise_bn_batches = precise_bn_batches
        self.ckpt: Optional[CheckpointManager] = None
        self.metrics_history = []

    def _device_batch(self, batch):
        """Numeric arrays and tensors of ``batch`` on the device, and those
        of each nested batch (a multi-task step's ``{task: batch}``); other
        values dropped."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, dict):
                out[k] = self._device_batch(v)
                continue
            if isinstance(v, np.ndarray) and v.dtype.kind in "biuf":
                v = torch.from_numpy(v)
            if isinstance(v, torch.Tensor):
                out[k] = v.to(self.device, non_blocking=True)
        return out

    def fit(self, train_loader, val_loader, state=None,
            resume_from: Optional[str] = None):
        """Train on ``train_loader``, validating on ``val_loader`` after
        each epoch; ``resume_from`` restores the last checkpoint of a
        Trainer checkpoint directory and continues at its next epoch."""
        task = self.task
        if state is None:
            state = task.build_state(self.seed)
        model_device = next(state.model.parameters()).device
        if model_device != self.device:
            raise ValueError(f"the model is on {model_device}, the Trainer "
                             f"on {self.device}")
        os.makedirs(self.root, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(self.root, "checkpoints"),
                                      task.checkpoint_metric,
                                      task.checkpoint_mode)
        start_epoch = 0
        if resume_from:
            state = CheckpointManager(resume_from, task.checkpoint_metric,
                                      task.checkpoint_mode).restore(state)
            start_epoch = last_epoch(resume_from) + 1
            logger.info(f"resumed from {resume_from} at epoch {start_epoch}")
        if _uncalibrated(state.model):
            state = task.calibrate_state(
                state, self._device_batch(next(iter(train_loader))))
            logger.info("calibrated int8 activation scales on one batch")
        generator = torch.Generator(self.device).manual_seed(self.seed + 1)
        epochs = 1 if self.fast_dev_run else self.max_epochs
        for epoch in range(start_epoch, max(epochs, start_epoch)):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            t0, n_seen, pending = time.time(), 0, None
            for i, batch in enumerate(train_loader):
                state, metrics = task.train_step(
                    state, self._device_batch(batch), generator)
                n_seen += 1
                if i % self.log_every == 0:
                    # log one interval late: reading the loss of the step
                    # just queued would wait for the card
                    self._log_loss(epoch, pending)
                    pending = (i, metrics)
                if self.fast_dev_run:
                    break
            self._log_loss(epoch, pending)
            logger.info(f"epoch {epoch} done: {n_seen} steps in "
                        f"{time.time() - t0:.1f}s")
            if self.precise_bn_batches > 0:
                self._run_precise_bn(state, train_loader)
            val_metrics = self.validate(state, val_loader)
            self.metrics_history.append({"epoch": epoch, **val_metrics})
            if not self.fast_dev_run:
                self.ckpt.save(state, epoch, val_metrics)
        return state

    def _run_precise_bn(self, state, train_loader) -> None:
        """The BN running statistics recomputed over ``precise_bn_batches``
        train batches (a no-op for a task without ``bn_forward_args``)."""
        task = self.task

        def batches():
            for batch in train_loader:
                args = task.bn_forward_args(self._device_batch(batch))
                if args is None:
                    return
                yield args

        n = compute_precise_bn_stats(state.model, batches(),
                                     self.precise_bn_batches)
        logger.info(f"precise BN: statistics recomputed over {n} batches")

    @staticmethod
    def _log_loss(epoch, pending):
        if pending is not None:
            i, metrics = pending
            logger.info(f"epoch {epoch} step {i} loss "
                        f"{float(metrics['loss']):.4f}")

    def validate(self, state, val_loader) -> Dict[str, float]:
        task = self.task
        ctx = task.start_validation()
        for batch in val_loader:
            task.accumulate(ctx, task.eval_step(
                state, self._device_batch(batch)), batch)
            if self.fast_dev_run:
                break
        metrics = task.finalize_validation(ctx)
        logger.info("validation: " + ", ".join(
            f"{k}={v:.4f}" for k, v in metrics.items()))
        return metrics

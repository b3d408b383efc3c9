"""Task protocol: what a Trainer calls.

Counterpart of ``egot2x/tasks/base.py``. A task owns the model, its loss,
the train and eval steps and the validation aggregation. The JAX steps
are pure functions of (state, batch, rng) that the Trainer jits; the
port's act on the :class:`~egot2x_torch.train.state.TrainState` in place
and return it, and take the ``torch.Generator`` that draws the step's
dropout masks in place of the rng.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from egot2x_torch.core.registry import build_model
from egot2x_torch.data.bucketing import BucketBatchLoader
from egot2x_torch.data.pipeline import BatchLoader
from egot2x_torch.nn.common import set_dropout_generator
from egot2x_torch.nn.quant import calibrate
from egot2x_torch.train.optim import construct_optimizer
from egot2x_torch.train.state import TrainState


def resolve_dtype(cfg) -> torch.dtype:
    """``cfg.compute_dtype`` in {float32, bf16, bfloat16} -> the compute
    dtype (parameters and statistics stay f32)."""
    name = str(cfg.get("compute_dtype", "float32")).lower()
    return torch.bfloat16 if name in ("bf16", "bfloat16") else torch.float32


class Task:
    # the metric that ranks checkpoints, and whether higher is better
    checkpoint_metric: str = "val_loss"
    checkpoint_mode: str = "min"

    def build_state(self, seed: int = 0) -> TrainState:
        raise NotImplementedError

    def train_step(self, state: TrainState, batch: Dict[str, Any],
                   generator: torch.Generator
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def eval_step(self, state: TrainState,
                  batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _model_inputs(self, batch) -> tuple:
        raise NotImplementedError

    def bn_forward_args(self, batch):
        """The model's inputs for a precise-BN forward on ``batch``; None:
        the task has no precise BN (the Trainer's hook does nothing)."""
        return None

    def calibrate_state(self, state: TrainState, batch) -> TrainState:
        """One float calibration forward of the model in eval mode on
        ``batch``, recording its int8 activation scales (static PTQ); the
        Trainer calls it on the first batch while the scales are 0."""
        state.model.eval()
        calibrate(state.model, *self._model_inputs(batch))
        return state

    # -- validation aggregation (host side) -------------------------------
    def start_validation(self) -> Any:
        return []

    def accumulate(self, ctx: Any, outputs: Dict[str, Any],
                   batch: Dict[str, Any]) -> None:
        ctx.append((outputs, batch))

    def finalize_validation(self, ctx: Any) -> Dict[str, float]:
        raise NotImplementedError

    def merge_validation(self, ctxs) -> Any:
        """One context from the per-process ones; the port runs one
        process until DDP is ported (ROADMAP.md §1 item 2)."""
        if len(ctxs) != 1:
            raise NotImplementedError("multi-process validation is not "
                                      "ported yet (ROADMAP.md §1 item 2)")
        return ctxs[0]


def batch_loader(cfg, dataset, batch_size: int, mode: str):
    """The JAX tasks' ``BatchLoader`` of ``dataset``: ``cfg.seed`` orders
    the train epochs, ``cfg.num_workers`` threads build the items."""
    return BatchLoader(dataset, batch_size, mode=mode,
                       seed=cfg.get("seed", 0) if mode == "train" else 0,
                       num_workers=cfg.get("num_workers", 8))


def bucket_loader(cfg, dataset, buckets, mode: str, frames_budget=None):
    """The JAX tasks' ``BucketBatchLoader`` of ``dataset`` at
    ``cfg.batch_size`` frames a batch (or ``frames_budget``)."""
    return BucketBatchLoader(
        dataset, frames_budget=frames_budget or cfg.batch_size,
        buckets=buckets, mode=mode,
        seed=cfg.get("seed", 0) if mode == "train" else 0,
        num_workers=cfg.get("num_workers", 8))


def weighted_cross_entropy(logits, labels, weights):
    """CE of (..., C) logits against integer labels (...) with per-class
    weights, torch ``CrossEntropyLoss(weight=)`` semantics: the mean is
    weighted by the selected class's weight."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, labels[..., None])[..., 0]
    w = torch.as_tensor(weights, device=logits.device)[labels]
    return -(w * picked).sum() / w.sum()


class ModelTask(Task):
    """A task over one registered model: built from ``cfg.model`` (or
    ``model``) on ``device`` with ``kwargs``, its weights drawn from a seed
    (the weight bridge's seeded tree) with Adam over every parameter, and a
    train step that minimises ``loss(outputs, batch)`` of a training-mode
    forward whose dropout masks the step's generator draws."""

    def __init__(self, cfg, device=None, model: str = None, **kwargs):
        self.cfg = cfg
        self.model = build_model(model or cfg.model, device=device, **kwargs)
        self.device = next(self.model.parameters()).device

    def build_state(self, seed: int = 0) -> TrainState:
        from egot2x_torch.core import bridge   # it imports the tasks

        model = self.model
        bridge.load_jax_variables(model,
                                  bridge.random_jax_variables(model, seed))
        return TrainState(model, self._optimizer(
            dict(model.named_parameters())))

    def _optimizer(self, params):
        return construct_optimizer(params, "adam", lr=self.cfg.lr)

    def loss(self, outputs, batch):
        raise NotImplementedError

    def train_step(self, state, batch, generator):
        model = set_dropout_generator(state.model.train(), generator)
        outputs = model(*self._model_inputs(batch))
        loss = self.loss(outputs, batch)
        state.apply_loss(loss)
        return state, self._metrics(loss.detach(), outputs, batch)

    def _metrics(self, loss, outputs, batch):
        return {"loss": loss}

    def forward_eval(self, state, batch):
        model = state.model.eval()
        with torch.no_grad():
            return model(*self._model_inputs(batch))

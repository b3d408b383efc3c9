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

from egot2x_torch.nn.quant import calibrate
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

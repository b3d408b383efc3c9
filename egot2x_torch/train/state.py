"""Train state: the model with its trainable/frozen split, the optimizer
and the step count.

Counterpart of ``egot2x/train/state.py``. The JAX package holds trainable
and frozen leaves in two trees and the optimizer state over the first
only; the port keeps one module, marks the frozen parameters
``requires_grad=False`` and gives the optimizer exactly the trainable
ones. BN statistics and int8 scales are the module's buffers, and go into
checkpoints with the model's ``state_dict``; a learning-rate scheduler
goes beside the optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    # stepped once per train step, as optax counts a schedule's steps
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None

    def apply_loss(self, loss: torch.Tensor) -> "TrainState":
        """Backpropagate ``loss`` from fresh gradients, then one optimizer
        step and one scheduler step."""
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.step += 1
        return self

    def state_dict(self) -> dict:
        state = {"step": self.step, "model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict()}
        if self.scheduler is not None:
            state["scheduler"] = self.scheduler.state_dict()
        return state

    def load_state_dict(self, state: dict) -> "TrainState":
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])
        return self


def split_params(model: nn.Module, is_frozen: Callable[[str], bool]
                 ) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """(trainable, frozen) parameters of ``model`` by the predicate on
    their top-level module name; the frozen ones get
    ``requires_grad=False`` (a predicate that freezes nothing, as
    ``nofreeze`` gives, leaves every parameter trainable)."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        if is_frozen(name.split(".", 1)[0]):
            p.requires_grad_(False)
            frozen[name] = p
        else:
            trainable[name] = p
    return trainable, frozen

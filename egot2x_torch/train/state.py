"""Train state: the model with its trainable/frozen split, the optimizer
and the step count.

Counterpart of ``egot2x/train/state.py``. The JAX package holds trainable
and frozen leaves in two trees and the optimizer state over the first
only; the port keeps one module, marks the frozen parameters
``requires_grad=False`` and gives the optimizer exactly the trainable
ones. BN statistics and int8 scales are the module's buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> "TrainState":
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        return self


def split_params(model: nn.Module, is_frozen: Callable[[str], bool]
                 ) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """(trainable, frozen) parameters of ``model`` by the predicate on
    their top-level module name; the frozen ones get
    ``requires_grad=False``."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        if is_frozen(name.split(".", 1)[0]):
            p.requires_grad_(False)
            frozen[name] = p
        else:
            trainable[name] = p
    return trainable, frozen

"""The optimizer factory.

Counterpart of ``egot2x/train/optim.py::construct_optimizer`` for the
method Stage-II training uses, ``adam``: optax's ``chain(masked(
add_decayed_weights(wd)), adam(lr))`` adds the L2 term to the gradient
of every leaf with two or more axes before Adam, which is torch ``Adam``
with coupled ``weight_decay`` on one parameter group and none on the
other (norm scales and biases, ndim <= 1). The packed ``in_proj_weight``
(2-D) and ``in_proj_bias`` (1-D) fall on the sides of the JAX package's
q/k/v kernels and biases; ``task_embed`` (1, n, D) decays in both.
``sgd``, ``adamw`` and the LR schedules are not ported yet
(ROADMAP.md §1 item 2).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def construct_optimizer(params: Dict[str, nn.Parameter],
                        method: str = "adam", lr: float = 1e-4,
                        weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam over ``params`` (name -> parameter), decay off norm and bias
    parameters."""
    if method != "adam":
        raise NotImplementedError(
            f"optimizer {method!r}: the port has 'adam' only so far "
            "(ROADMAP.md §1 item 2)")
    groups = [
        {"params": [p for p in params.values() if p.ndim >= 2],
         "weight_decay": weight_decay},
        {"params": [p for p in params.values() if p.ndim <= 1],
         "weight_decay": 0.0}]
    return torch.optim.Adam([g for g in groups if g["params"]], lr=lr)

"""The optimizer factory.

Counterpart of ``egot2x/train/optim.py::construct_optimizer`` for the
method Stage-II training uses, ``adam``: optax's ``chain(masked(
add_decayed_weights(wd)), adam(lr))`` adds the L2 term to the gradient
of every leaf the mask picks before Adam, which is torch ``Adam`` with
coupled ``weight_decay`` on one parameter group and none on the other.
The mask (``_norm_bias_mask``) decays every leaf with two or more axes in
the JAX layout (``ndim >= 2``), and no norm scale or bias. The port's
parameters have their JAX leaf's rank, but for the leaves it stores with
extra unit axes: gLN's scale and offset, (C,) in JAX and (1, C, 1) here,
exempt by name (``UNIT_AXIS_LEAVES``). So a Dense(1) kernel, a (1, D)
weight here, and a (1, 1, D) token decay, as in JAX. The packed
``in_proj_weight`` (2-D) and ``in_proj_bias`` (1-D) fall on the sides of
the JAX package's q/k/v kernels and biases; ``task_embed`` (1, n, D)
decays in both.
The one schedule a task runs, the ASD task's per-step exponential decay
(``optax.exponential_decay(lr, transition_steps=1, decay_rate=d)``, step
k at lr d^k), is :func:`exponential_decay`. ``sgd``, ``adamw`` and the
other schedules are not ported yet (ROADMAP.md §1).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


# parameter names the port stores with unit axes the JAX leaf lacks
# (nn/talknet.py's GlobalLayerNorm: (1, C, 1) for JAX's (C,))
UNIT_AXIS_LEAVES = ("gamma", "beta")


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether parameter ``name`` takes weight decay: its JAX leaf has two
    or more axes."""
    return p.dim() >= 2 and name.rsplit(".", 1)[-1] not in UNIT_AXIS_LEAVES


def construct_optimizer(params: Dict[str, nn.Parameter],
                        method: str = "adam", lr: float = 1e-4,
                        weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam over ``params`` (name -> parameter), decay off norm and bias
    parameters."""
    if method != "adam":
        raise NotImplementedError(
            f"optimizer {method!r}: the port has 'adam' only so far "
            "(ROADMAP.md §1)")
    groups = [
        {"params": [p for n, p in params.items() if decays(n, p)],
         "weight_decay": weight_decay},
        {"params": [p for n, p in params.items() if not decays(n, p)],
         "weight_decay": 0.0}]
    return torch.optim.Adam([g for g in groups if g["params"]], lr=lr)


def exponential_decay(optimizer: torch.optim.Optimizer, decay_rate: float
                      ) -> torch.optim.lr_scheduler.LRScheduler:
    """optax's ``exponential_decay(lr, transition_steps=1, decay_rate)``:
    stepped once after each optimizer step, the k-th step (from 0) runs at
    lr * decay_rate ** k."""
    return torch.optim.lr_scheduler.ExponentialLR(optimizer, decay_rate)

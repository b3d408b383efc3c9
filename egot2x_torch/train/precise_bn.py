"""Precise BN: recompute BatchNorm's running statistics after training.

Counterpart of ``egot2x/train/precise_bn.py`` (the reference's fvcore
``update_bn_stats`` and ``SubBatchNorm3d.aggregate_stats``): the running
statistics become the mean over up to ``num_batches`` training-mode
forwards of each batch's own mean and (biased) variance, what the model
would see at inference from a converged average, in place of the
momentum's EMA.

The port's BNs train with flax's semantics (``nn/layers.py``), so a layer
whose momentum is 1 sets its running statistics to the batch's exactly;
the JAX package recovers them from its EMA update with momentum 0.9 (which
is its ResNets' momentum, the layers ``run_lam`` recomputes). Only the
BatchNorm layers run in training mode (dropout stays off), under
``no_grad``.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
from torch import nn


def compute_precise_bn_stats(model: nn.Module, batches: Iterable,
                             num_batches: int = 200) -> int:
    """Set every BatchNorm's running mean and variance in ``model`` to the
    average of its batch statistics over the first ``num_batches`` of
    ``batches`` (tuples of the model's positional inputs); returns the
    number of batches used (0 leaves the statistics as they were)."""
    bns = [m for m in model.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    if not bns:
        return 0
    was_training = model.training
    momenta = [m.momentum for m in bns]
    sums = [None] * len(bns)
    n = 0
    model.eval()
    for m in bns:
        m.train()
        m.momentum = 1.0   # running <- this batch's statistics
    try:
        with torch.no_grad():
            for args in batches:
                if n >= num_batches:
                    break
                model(*(args if isinstance(args, (tuple, list)) else (args,)))
                for k, m in enumerate(bns):
                    stats = (m.running_mean.clone(), m.running_var.clone())
                    sums[k] = stats if sums[k] is None else (
                        sums[k][0] + stats[0], sums[k][1] + stats[1])
                n += 1
    finally:
        for m, mom in zip(bns, momenta):
            m.momentum = mom
        model.train(was_training)
    if n:
        for m, (mean, var) in zip(bns, sums):
            m.running_mean.copy_(mean / n)
            m.running_var.copy_(var / n)
    return n


def aggregate_sub_batch_stats(means: np.ndarray, vars_: np.ndarray):
    """SubBatchNorm's aggregate of per-split (mean, var) into one:
    var = E[v_i] + E[(m_i - m)^2]."""
    mean = means.mean(axis=0)
    var = vars_.mean(axis=0) + ((means - mean) ** 2).mean(axis=0)
    return mean, var

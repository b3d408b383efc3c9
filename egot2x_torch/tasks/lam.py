"""The LAM/TTM tasks' loss.

Counterpart of ``weighted_cross_entropy`` in ``egot2x/tasks/lam.py``; the
rest of the LAM task (the Stage-I models, their data) is not ported yet
(ROADMAP.md §1 item 3).
"""

from __future__ import annotations

import torch


def weighted_cross_entropy(logits, labels, weights):
    """CE of (..., C) logits against integer labels (...) with per-class
    weights, torch ``CrossEntropyLoss(weight=)`` semantics: the mean is
    weighted by the selected class's weight."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, labels[..., None])[..., 0]
    w = torch.as_tensor(weights, device=logits.device)[labels]
    return -(w * picked).sum() / w.sum()

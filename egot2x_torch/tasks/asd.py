"""ASD task, inference: frame-level evaluation of ``TalkNetWithHeads``.

Counterpart of ``egot2x/tasks/asd.py`` without its training half (Stage-I
training normalises the stems with batch statistics, which the stem
kernels do not compute; ROADMAP.md §1 item 2). The metric is the
reference's: frame accuracy correct / total of the AV head's argmax,
summed over the valid tracks of every batch; the Stage-II ASD task
(``tasks/asd_2loader.py``) validates the same way.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from egot2x_torch.tasks.lam import weighted_cross_entropy

ASD_CLASS_WEIGHTS = np.asarray([1.0, 4.0], dtype=np.float32)
ASD_BUCKETS = (15, 30, 60, 90, 120, 150)


# per-frame weighted CE over (..., 2) logits, the JAX package's name
frame_weighted_ce = weighted_cross_entropy


class FrameAccuracy:
    """Validation by frame accuracy: an eval step's per-track ``correct``
    and ``total`` frames, summed over the tracks whose ``valid`` is True
    (all when the batch has no ``valid``: False marks a bucket's padding
    tracks)."""

    checkpoint_metric = "val_acc"
    checkpoint_mode = "max"

    def start_validation(self):
        return {"correct": 0, "total": 0}

    def accumulate(self, ctx, outputs, batch):
        correct = outputs["correct"].cpu().numpy()
        valid = np.asarray(batch.get("valid", np.ones(len(correct), bool)))
        ctx["correct"] += int(correct[valid].sum())
        ctx["total"] += int(outputs["total"].cpu().numpy()[valid].sum())

    def finalize_validation(self, ctx) -> Dict[str, float]:
        return {"val_acc": ctx["correct"] / max(ctx["total"], 1)}


class ActiveSpeakerDetection(FrameAccuracy):
    """Frame-accuracy validation of a Stage-I ASD model
    (``TalkNetWithHeads``), whose batches hold ``mfcc`` (B, 4T, 13),
    ``faces`` (B, T, H, W), ``labels`` (B, T) and optionally ``valid``
    (B,)."""

    def __init__(self, model: torch.nn.Module):
        self.model = model

    def eval_step(self, batch) -> Dict[str, torch.Tensor]:
        """Per-track ``correct`` and ``total`` frames (int32) and the
        per-frame speaking ``scores`` of the AV head."""
        with torch.no_grad():
            logits = self.model(batch["mfcc"], batch["faces"])["logits_av"]
        labels = batch["labels"][:, :logits.shape[1]]
        correct = (logits.argmax(-1) == labels).to(torch.int32).sum(dim=1)
        return {"correct": correct,
                "total": torch.full_like(correct, labels.shape[1]),
                "scores": torch.softmax(logits, dim=-1)[..., 1]}

"""ASD task, inference: frame-level evaluation of ``TalkNetWithHeads``.

Counterpart of ``egot2x/tasks/asd.py`` without its training half (the
optimizer, the train step and the data loaders come with the port's
trainer). The metric is the reference's: frame accuracy correct / total
of the AV head's argmax, summed over the valid tracks of every batch.
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


class ActiveSpeakerDetection:
    """Frame-accuracy validation of a Stage-I ASD model
    (``TalkNetWithHeads``), whose batches hold ``mfcc`` (B, 4T, 13),
    ``faces`` (B, T, H, W), ``labels`` (B, T) and optionally ``valid``
    (B,), False for the padding tracks of a bucket."""

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

    def start_validation(self):
        return {"correct": 0, "total": 0}

    def accumulate(self, ctx, outputs, batch):
        correct = outputs["correct"].cpu().numpy()
        valid = np.asarray(batch.get("valid", np.ones(len(correct), bool)))
        ctx["correct"] += int(correct[valid].sum())
        ctx["total"] += int(outputs["total"].cpu().numpy()[valid].sum())

    def finalize_validation(self, ctx) -> Dict[str, float]:
        return {"val_acc": ctx["correct"] / max(ctx["total"], 1)}

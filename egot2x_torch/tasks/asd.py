"""ASD task: Stage-I training of TalkNet with its heads, frame accuracy.

Counterpart of ``egot2x/tasks/asd.py`` (``ActiveSpeakerDetection``):
``TalkNetWithHeads`` (``cfg.model``) on batches of ``mfcc`` (B, 4T, 13),
``faces`` (B, T, H, W) grey in [0, 255], ``labels`` (B, T) and optionally
``valid`` (B,). ``build_state`` draws the weights from a seed (the weight
bridge's seeded tree) and hands every parameter to Adam (no weight
decay) at ``cfg.lr``, decayed after every step by ``cfg.lr_decay`` (the
reference's StepLR of step 1, optax's ``exponential_decay``; none at
1.0). ``train_step`` runs the model in training mode (BNs on batch
statistics, dropout 0.1 in the attention layers with masks from the
step's generator) under lossAV + 0.4 lossA + 0.4 lossV, each a per-frame
CE weighted [1, 4] with the labels cut to the logits' T; its metrics are
the loss and the AV head's frame accuracy. Validation is frame accuracy
correct / total of the AV head's argmax over the valid tracks
(``FrameAccuracy``, which the Stage-II task shares). The model runs on the
card unless ``device`` says otherwise, and so do its loaders' items:
``train_loader`` and ``val_loader`` bucket the trials of ``data/asd.py``
(``cfg.data_root``, ``batch_size`` frames a batch over ``ASD_BUCKETS``;
train items augmented).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from egot2x_torch.data.asd import AsdTrialDataset
from egot2x_torch.tasks.base import (ModelTask, bucket_loader,
                                     weighted_cross_entropy)
from egot2x_torch.train.optim import exponential_decay

ASD_CLASS_WEIGHTS = np.asarray([1.0, 4.0], dtype=np.float32)
ASD_BUCKETS = (15, 30, 60, 90, 120, 150)
# the loss of each head: lossAV + 0.4 lossA + 0.4 lossV
HEAD_WEIGHTS = {"logits_av": 1.0, "logits_a": 0.4, "logits_v": 0.4}


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


class TrialLoaders:
    """The ASD tasks' loaders: their ``_dataset``'s trials bucketed at
    ``cfg.batch_size`` frames a batch over ``ASD_BUCKETS``."""

    def train_loader(self):
        return bucket_loader(self.cfg, self._dataset("train"), ASD_BUCKETS,
                             "train")

    def val_loader(self):
        return bucket_loader(self.cfg, self._dataset("val"), ASD_BUCKETS,
                             "eval")


class ActiveSpeakerDetection(FrameAccuracy, TrialLoaders, ModelTask):
    def __init__(self, cfg, device=None):
        super().__init__(cfg, device, model=cfg.get("model",
                                                    "TalkNetWithHeads"))
        self.class_weights = torch.from_numpy(ASD_CLASS_WEIGHTS).to(
            self.device)

    def build_state(self, seed: int = 0):
        state = super().build_state(seed)
        decay = self.cfg.get("lr_decay", 1.0)
        if decay != 1.0:
            state.scheduler = exponential_decay(state.optimizer, decay)
        return state

    def _model_inputs(self, batch):
        return (batch["mfcc"], batch["faces"])

    def _dataset(self, split):
        return AsdTrialDataset(self.cfg.data_root, split=split,
                               device=self.device)

    def _labels(self, outputs, batch):
        return batch["labels"][:, :outputs["logits_av"].shape[1]].long()

    def loss(self, outputs, batch):
        """lossAV + 0.4 lossA + 0.4 lossV, each in f32."""
        labels = self._labels(outputs, batch)
        return sum(w * weighted_cross_entropy(outputs[k].float(), labels,
                                              self.class_weights)
                   for k, w in HEAD_WEIGHTS.items())

    def _metrics(self, loss, outputs, batch):
        pred = outputs["logits_av"].detach().argmax(-1)
        acc = (pred == self._labels(outputs, batch)).float().mean()
        return {"loss": loss, "acc": acc}

    def eval_step(self, state, batch) -> Dict[str, torch.Tensor]:
        """Per-track ``correct`` and ``total`` frames (int32) and the
        per-frame speaking ``scores`` of the AV head."""
        logits = self.forward_eval(state, batch)["logits_av"]
        labels = batch["labels"][:, :logits.shape[1]]
        correct = (logits.argmax(-1) == labels).to(torch.int32).sum(dim=1)
        return {"correct": correct,
                "total": torch.full_like(correct, labels.shape[1]),
                "scores": torch.softmax(logits, dim=-1)[..., 1]}

"""LAM (looking-at-me) task: Stage-I training and mAP validation.

Counterpart of ``egot2x/tasks/lam.py`` (``LookingAtMe``): a Stage-I LAM
classifier (``BaselineLSTM`` or ``GazeLSTM``, ``cfg.model``) on batches
of ``frames`` (B, 7, H, W, 3), ``label`` (B,), and for validation ``uid``
(B strings) and optionally ``valid`` (B,). ``build_state`` draws the
weights from a seed (the weight bridge's seeded tree) and hands Adam every
parameter; ``train_step`` runs the model in training mode (BNs on batch
statistics, updating their running statistics as flax does) under the
CE weighted by ``cfg.weights`` (run_lam: [0.136, 0.864]); ``eval_step``
scores the looking-at-me class's softmax; validation is AVA-style mAP
and accuracy at 0.5 over the collected rows (``metrics/map.py``). The
model runs on the card unless ``device`` says otherwise, and so do its
loaders' items: ``train_loader`` and ``val_loader`` batch the 7-frame
face clips of ``data/lam.py`` (``cfg.data_root``, ``train_stride`` /
``val_stride``, ``img_size``, ``batch_size``); ``bn_forward_args`` feeds
the Trainer's precise BN.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from egot2x_torch.data.lam import LamClipDataset
from egot2x_torch.metrics.map import run_evaluation
from egot2x_torch.tasks.base import (ModelTask, batch_loader, resolve_dtype,
                                     weighted_cross_entropy)


class LookingAtMe(ModelTask):
    checkpoint_metric = "val_mAP"
    checkpoint_mode = "max"

    def __init__(self, cfg, device=None):
        super().__init__(cfg, device, dtype=resolve_dtype(cfg))
        self.class_weights = torch.tensor(cfg.weights, dtype=torch.float32,
                                          device=self.device)

    def _model_inputs(self, batch):
        return (batch["frames"],)

    def bn_forward_args(self, batch):
        return (batch["frames"],)

    # -- data ----------------------------------------------------------------
    def _dataset(self, split):
        c = self.cfg
        return LamClipDataset(
            c.data_root, split=split,
            stride=c.train_stride if split == "train" else c.val_stride,
            img_size=c.img_size, device=self.device)

    def train_loader(self):
        return batch_loader(self.cfg, self._dataset("train"),
                            self.cfg.batch_size, "train")

    def val_loader(self):
        return batch_loader(self.cfg, self._dataset("val"),
                            self.cfg.batch_size, "eval")

    def loss(self, logits, batch):
        """The class-weighted CE, in f32."""
        return weighted_cross_entropy(logits.float(), batch["label"].long(),
                                      self.class_weights)

    def eval_step(self, state, batch) -> Dict[str, torch.Tensor]:
        """The looking-at-me ``scores`` (B,), softmax[:, 1]."""
        logits = self.forward_eval(state, batch)
        return {"scores": torch.softmax(logits.float(), dim=-1)[:, 1]}

    # -- validation aggregation (the reference PostProcessor's) ------------
    def start_validation(self):
        return {"uids": [], "labels": [], "scores": []}

    def accumulate(self, ctx, outputs, batch):
        scores = outputs["scores"].cpu().numpy()
        valid = np.asarray(batch.get("valid", np.ones(len(scores), bool)))
        for i in range(len(scores)):
            if not valid[i]:
                continue
            ctx["uids"].append(batch["uid"][i])
            ctx["labels"].append(int(batch["label"][i]))
            ctx["scores"].append(float(scores[i]))

    def finalize_validation(self, ctx) -> Dict[str, float]:
        if not ctx["uids"]:
            return {"val_mAP": 0.0, "val_acc": 0.0}
        m_ap, acc = run_evaluation(ctx["uids"], np.asarray(ctx["labels"]),
                                   np.asarray(ctx["scores"]))
        return {"val_mAP": m_ap, "val_acc": acc}

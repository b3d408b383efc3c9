"""TTM (talking-to-me) task: Stage-I training and per-segment validation.

Counterpart of ``egot2x/tasks/ttm.py`` (``TalkingToMe``): a Stage-I TTM
classifier (``TTMBaselineLSTM``, ``cfg.model``) on batches of ``frames``
(B, T, H, W, 3), raw 16 kHz ``audio`` (B, T / 30 * 16000) and ``label``
(B,), and for validation ``seg_id``, ``start``, ``end`` (B each) and
optionally ``valid`` (B,). ``build_state`` draws the weights from a seed
(the weight bridge's seeded tree) and hands every parameter to Adam with
weight decay ``cfg.wd`` through the JAX package's mask
(``train/optim.py``); ``train_step`` runs the model in training mode (BNs
on batch statistics) under the CE weighted by ``cfg.weights``;
``eval_step`` returns the logits. Validation: a segment split into chunks
across buckets averages its chunks' logits before the softmax, then
AVA-style mAP and accuracy over segments (``metrics/map.py``); processes'
contexts merge by segment. The Stage-II translators train through
``tasks/ttm_2loader.py``, which this task's steps and validation serve.
The model runs on the card unless ``device`` says otherwise, and so do its
loaders' items: ``train_loader`` and ``val_loader`` bucket the segments of
``data/ttm.py`` (``cfg.data_root``, ``img_size``; ``batch_size`` frames a
batch over ``buckets``, 15 to 150 frames).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from egot2x_torch.data.bucketing import DEFAULT_BUCKETS
from egot2x_torch.data.ttm import TtmSegmentDataset
from egot2x_torch.metrics.map import run_evaluation
from egot2x_torch.tasks.base import (ModelTask, bucket_loader, resolve_dtype,
                                     weighted_cross_entropy)
from egot2x_torch.train.optim import construct_optimizer


class TalkingToMe(ModelTask):
    checkpoint_metric = "val_mAP"
    checkpoint_mode = "max"

    def __init__(self, cfg, device=None, **kwargs):
        super().__init__(cfg, device, dtype=resolve_dtype(cfg), **kwargs)
        self.class_weights = torch.tensor(cfg.weights, dtype=torch.float32,
                                          device=self.device)

    def _optimizer(self, params):
        return construct_optimizer(params, "adam", lr=self.cfg.lr,
                                   weight_decay=self.cfg.get("wd", 0.0))

    def _model_inputs(self, batch):
        return (batch["frames"], batch["audio"])

    @property
    def buckets(self):
        return tuple(self.cfg.get("buckets", DEFAULT_BUCKETS))

    # -- data ----------------------------------------------------------------
    def _dataset(self, split):
        c = self.cfg
        return TtmSegmentDataset(c.data_root, split=split,
                                 img_size=c.img_size, device=self.device)

    def train_loader(self):
        return bucket_loader(self.cfg, self._dataset("train"), self.buckets,
                             "train")

    def val_loader(self):
        return bucket_loader(self.cfg, self._dataset("val"), self.buckets,
                             "eval")

    def loss(self, logits, batch):
        """The class-weighted CE, in f32."""
        return weighted_cross_entropy(logits.float(), batch["label"].long(),
                                      self.class_weights)

    def eval_step(self, state, batch):
        return {"logits": self.forward_eval(state, batch)}

    # -- validation: per-segment logit averaging ---------------------------
    def start_validation(self):
        return {"logits": defaultdict(list), "label": {}, "span": {}}

    def accumulate(self, ctx, outputs, batch):
        logits = outputs["logits"].float().cpu().numpy()
        valid = np.asarray(batch.get("valid", np.ones(len(logits), bool)))
        for i in range(len(logits)):
            if not valid[i]:
                continue
            seg = batch["seg_id"][i]
            ctx["logits"][seg].append(logits[i])
            ctx["label"][seg] = int(batch["label"][i])
            s, e = int(batch["start"][i]), int(batch["end"][i])
            lo, hi = ctx["span"].get(seg, (s, e))
            ctx["span"][seg] = (min(lo, s), max(hi, e))

    def merge_validation(self, ctxs):
        """Per-process contexts into one: a segment's chunks concatenate,
        labels overwrite (equal), spans take their (min, max) envelope."""
        out = self.start_validation()
        for c in ctxs:
            for seg, chunks in c["logits"].items():
                out["logits"][seg].extend(chunks)
            out["label"].update(c["label"])
            for seg, (s, e) in c["span"].items():
                lo, hi = out["span"].get(seg, (s, e))
                out["span"][seg] = (min(lo, s), max(hi, e))
        return out

    def finalize_validation(self, ctx) -> Dict[str, float]:
        if not ctx["logits"]:
            return {"val_mAP": 0.0, "val_acc": 0.0}
        uids, labels, scores = [], [], []
        for seg, chunks in ctx["logits"].items():
            mean_logits = np.mean(np.stack(chunks), axis=0)
            p = np.exp(mean_logits - mean_logits.max())
            p = p / p.sum()
            uids.append(seg)
            labels.append(ctx["label"][seg])
            scores.append(float(p[1]))
        m_ap, acc = run_evaluation(uids, np.asarray(labels),
                                   np.asarray(scores))
        return {"val_mAP": m_ap, "val_acc": acc}

"""TTM (talking-to-me) task: evaluation and per-segment mAP validation.

Counterpart of the validation half of ``egot2x/tasks/ttm.py``
(``TalkingToMe``): a segment split into chunks across buckets averages
its chunks' logits before the softmax, then AVA-style mAP and accuracy
over segments (``metrics/map.py``). The Stage-I TTM models and their
training come later (ROADMAP.md §1 item 3); the Stage-II translators
train through ``tasks/ttm_2loader.py``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from egot2x_torch.metrics.map import run_evaluation
from egot2x_torch.tasks.base import Task


class TalkingToMe(Task):
    checkpoint_metric = "val_mAP"
    checkpoint_mode = "max"

    def _model_inputs(self, batch):
        return (batch["frames"], batch["audio"])

    def eval_step(self, state, batch):
        model = state.model.eval()
        with torch.no_grad():
            return {"logits": model(*self._model_inputs(batch))}

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

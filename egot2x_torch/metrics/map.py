"""AVA-style mean average precision for LAM/TTM validation.

The port's numpy copy of ``egot2x/metrics/map.py::run_evaluation`` (the
reference's HHI/utils/{lam,ttm}/metrics.py math, in memory):
  * rows deduplicated by uid, the first occurrence kept;
  * two APs, class 1 on (label, score) and class 0 on (1 - label,
    1 - score), each over the rows sorted by score descending (stable);
    mAP is their mean;
  * VOC AP: sentinels, a non-increasing precision envelope, step areas;
  * top-1 accuracy at the threshold 0.5.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def compute_average_precision(precision: np.ndarray,
                              recall: np.ndarray) -> float:
    """VOCdevkit AP."""
    if precision.size == 0:
        return 0.0
    recall = np.concatenate([[0.0], recall, [1.0]])
    precision = np.concatenate([[0.0], precision, [0.0]])
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    idx = np.where(recall[1:] != recall[:-1])[0] + 1
    return float(np.sum((recall[idx] - recall[idx - 1]) * precision[idx]))


def _precision_recall(labels_sorted: np.ndarray):
    tp = np.cumsum(labels_sorted)
    precision = tp / np.arange(1, len(labels_sorted) + 1)
    recall = tp / max(labels_sorted.sum(), 1)
    return precision, recall


def run_evaluation(uids: Sequence[str], labels, scores,
                   threshold: float = 0.5) -> Tuple[float, float]:
    """uids: row ids; labels: {0, 1}; scores: P(class 1). Returns (mAP,
    top-1 accuracy)."""
    labels = np.asarray(labels, dtype=np.int64)
    scores = np.asarray(scores, dtype=np.float64)
    first = {}
    for i, u in enumerate(uids):
        first.setdefault(u, i)
    keep = np.asarray(sorted(first.values()), dtype=np.int64)
    labels, scores = labels[keep], scores[keep]
    aps = []
    for lab, s in ((1 - labels, 1.0 - scores), (labels, scores)):
        order = np.argsort(-s, kind="stable")
        aps.append(compute_average_precision(*_precision_recall(lab[order])))
    acc = (float(np.mean((scores >= threshold) == (labels == 1)))
           if len(labels) else 0.0)
    return float(np.mean(aps)), acc

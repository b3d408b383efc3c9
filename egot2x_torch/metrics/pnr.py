"""PNR/OSCC metrics, on the host in numpy.

The port's own copy of ``egot2x/metrics/pnr.py``: ``keyframe_distance``
(|argmax (end - start) / num_frames - (pnr - start)| / fps, over the
state-change clips only), ``keyframe_accuracy`` (argmax of the prediction
against argmax of the label, over the state-change clips) and
``state_change_accuracy`` (argmax of the 2-class logits). Card tensors
are read with ``np.asarray(t.cpu())`` by the caller.
"""

from __future__ import annotations

import numpy as np


def keyframe_distance(preds, state_labels, fps, clip_start, clip_end,
                      pnr_frame, num_frames: int = 16):
    """Per-clip localisation error in seconds of (B, num_frames) keyframe
    logits or scores; returns (sum, count)."""
    total, count = 0.0, 0
    for p, sc, f, s, e, pnr in zip(preds, state_labels, fps, clip_start,
                                   clip_end, pnr_frame):
        if int(sc) != 1:
            continue
        loc = int(np.argmax(p))
        mapped = (e - s) / num_frames * loc
        total += abs(mapped - (pnr - s)) / f
        count += 1
    return total, count


def keyframe_accuracy(preds, labels, state_labels):
    """argmax match on the state-change clips; returns (correct, total)."""
    correct, total = 0, 0
    for p, lab, sc in zip(preds, labels, state_labels):
        if int(sc) != 1:
            continue
        total += 1
        correct += int(np.argmax(p)) == int(np.argmax(lab))
    return correct, total


def state_change_accuracy(preds, labels):
    """(correct, total) of (B, 2) state-change logits against (B,) labels."""
    pred_cls = np.argmax(preds, axis=-1)
    return int((pred_cls == np.asarray(labels)).sum()), len(labels)

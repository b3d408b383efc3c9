"""Static-shape bucketed batching of variable-length segments.

Counterpart of ``egot2x/data/bucketing.py``: segments are binned into a few
frame-count buckets and truncated down to the bucket's base length (the
reference's min-truncation collate at quantized lengths), so every batch
of a bucket has one shape. The per-bucket batch size keeps the frames
budget about constant: ``max(min_batch, frames_budget // base)``, capped
at ``max_batch``, rounded to a multiple of ``batch_divisor`` (1 on one
card). The plan of an epoch, its shuffles and its padding are the JAX
package's, from ``np.random.default_rng(seed + epoch)``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from egot2x_torch.data.pipeline import default_collate, pad_indices, prefetch

DEFAULT_BUCKETS = (15, 30, 60, 90, 120, 150)


class BucketedDataset:
    """Protocol: __len__, lengths (np.ndarray), get_item(idx, n_frames)."""

    def __len__(self) -> int:  # pragma: no cover - protocol
        raise NotImplementedError

    @property
    def lengths(self) -> np.ndarray:  # pragma: no cover - protocol
        raise NotImplementedError

    def get_item(self, idx: int, n_frames: int) -> Dict[str, Any]:
        raise NotImplementedError  # pragma: no cover - protocol


def assign_buckets(lengths: np.ndarray, buckets: Sequence[int]) -> np.ndarray:
    """Index of the largest bucket base <= length; shorter than the
    smallest -> the smallest (those items repeat their last frame)."""
    bases = np.asarray(sorted(buckets))
    idx = np.searchsorted(bases, lengths, side="right") - 1
    return np.clip(idx, 0, len(bases) - 1)


class BucketBatchLoader:
    """Static-shape batches grouped by length bucket. ``frames_budget``
    plays the reference's ``batch_size`` (~400 frames); eval mode keeps
    every item (pads a bucket's last batch, ``valid`` mask)."""

    def __init__(self, dataset: BucketedDataset, frames_budget: int = 400,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, mode: str = "train",
                 seed: int = 0, num_workers: int = 8, prefetch: int = 2,
                 min_batch: int = 1, max_batch: Optional[int] = None,
                 batch_divisor: int = 1,
                 collate_fn: Callable = default_collate):
        self.dataset = dataset
        self.frames_budget = frames_budget
        self.bases = sorted(buckets)
        self.mode = mode
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.min_batch = min_batch
        self.max_batch = max_batch
        self.batch_divisor = batch_divisor
        self.collate_fn = collate_fn
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def batch_size_for(self, base: int) -> int:
        bs = max(self.min_batch, self.frames_budget // base)
        if self.max_batch:
            bs = min(bs, self.max_batch)
        d = self.batch_divisor
        if d > 1:
            bs = max(d, (bs // d) * d)
        return bs

    def _plan(self) -> List[tuple]:
        """(base length, indices) of each batch of this epoch."""
        lengths = np.asarray(self.dataset.lengths)
        mine = np.arange(len(lengths))
        bucket_of = assign_buckets(lengths, self.bases)
        rng = np.random.default_rng(self.seed + self.epoch)
        plan: List[tuple] = []
        for b, base in enumerate(self.bases):
            idx = mine[bucket_of == b]
            if len(idx) == 0:
                continue
            if self.mode == "train":
                rng.shuffle(idx)
            bs = self.batch_size_for(base)
            n_full = len(idx) // bs
            plan += [(base, idx[i * bs:(i + 1) * bs]) for i in range(n_full)]
            rem = idx[n_full * bs:]
            if len(rem) and self.mode != "train":
                plan.append((base, rem))
            elif n_full == 0 and len(rem):
                # fewer items than one batch: repeat rather than drop the
                # bucket (tiny fixtures must still train)
                plan.append((base, np.resize(rem, bs)))
        if self.mode == "train":
            rng.shuffle(plan)
        return plan

    def __len__(self) -> int:
        return len(self._plan())

    def _make_batch(self, pool: ThreadPoolExecutor, entry):
        base, idx = entry
        idx, valid = pad_indices(idx, self.batch_size_for(base))
        batch = self.collate_fn(list(pool.map(
            lambda i: self.dataset.get_item(int(i), base), idx)))
        if self.mode != "train":
            batch["valid"] = valid
        return batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return prefetch(self._make_batch, self._plan(), self.num_workers,
                        self.prefetch)

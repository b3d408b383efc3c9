"""Batching: map-style datasets -> static-shape batches, prefetched.

Counterpart of ``egot2x/data/pipeline.py`` on one process:

  * every batch has one shape: train drops the last partial batch (a
    dataset smaller than one batch repeats itself to fill it); eval pads
    the last one by repeating its first item and marks the padding in
    ``valid`` (bool, (B,));
  * the train order is a permutation of ``np.random.default_rng(seed +
    epoch)``, the JAX package's;
  * a pool of ``num_workers`` threads builds a batch's items, and a
    background thread keeps ``prefetch`` batches ready. Items built on the
    card (the data plane's decode and crop, ``data/image.py``) come out as
    CUDA tensors, and ``default_collate`` stacks them there.

The JAX package shards the index over processes (its multi-host start-up);
the port runs one process (``ROADMAP.md``).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Sequence

import numpy as np
import torch


class Dataset:
    """Map-style dataset protocol: __len__ + __getitem__ -> dict."""

    def __len__(self) -> int:  # pragma: no cover - protocol
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Dict[str, Any]:  # pragma: no cover
        raise NotImplementedError


def default_collate(items: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack each key over the items: tensors with ``torch.stack`` on
    their device, numpy arrays and scalars with ``np.stack``; anything
    else (ids) as a list."""
    out: Dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], torch.Tensor):
            out[key] = torch.stack(vals)
        elif isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]):
            out[key] = np.stack([np.asarray(v) for v in vals])
        else:
            out[key] = list(vals)
    return out


def prefetch(make_batch: Callable, plan: Sequence, num_workers: int,
             depth: int) -> Iterator[Dict[str, Any]]:
    """``make_batch(pool, entry)`` for each entry of ``plan``, built ahead
    by a background thread (at most ``depth`` batches waiting) with a pool
    of ``num_workers`` threads; an exception in the producer is raised in
    the consumer."""
    if not plan:
        return iter(())
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    pool = ThreadPoolExecutor(max_workers=num_workers)

    def producer():
        try:
            for entry in plan:
                q.put(make_batch(pool, entry))
        except BaseException as e:  # noqa: BLE001 - raised in the consumer
            q.put(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=producer, daemon=True).start()

    def gen():
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            pool.shutdown(wait=False)

    return gen()


def pad_indices(idx: np.ndarray, batch_size: int):
    """``idx`` padded to ``batch_size`` by repeating its first index, and
    the ``valid`` mask of the real ones."""
    valid = np.ones(batch_size, dtype=bool)
    if len(idx) < batch_size:
        valid[len(idx):] = False
        idx = np.concatenate([idx, np.repeat(idx[:1],
                                             batch_size - len(idx))])
    return idx, valid


class BatchLoader:
    """Static-shape batch iterator with prefetch.

    mode='train': shuffle each epoch, drop the last partial batch.
    mode='eval' : in order, pad the last batch by repeating its item 0 and
                  mark the padding in batch['valid'] (bool, (B,)).
    """

    def __init__(self, dataset: Dataset, batch_size: int, mode: str = "train",
                 seed: int = 0, num_workers: int = 8, prefetch: int = 2,
                 collate_fn: Callable = default_collate):
        self.dataset = dataset
        self.batch_size = batch_size
        self.mode = mode
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.collate_fn = collate_fn
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.mode == "train":
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.mode == "train":
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _chunks(self):
        idx, bs = self._indices(), self.batch_size
        if self.mode != "train":
            return [idx[i:i + bs] for i in range(0, len(idx), bs)]
        chunks = [idx[i * bs:(i + 1) * bs] for i in range(len(idx) // bs)]
        if not chunks and len(idx):
            # smaller than one batch: repeat rather than drop the epoch
            chunks = [np.resize(idx, bs)]
        return chunks

    def _make_batch(self, pool: ThreadPoolExecutor, chunk: np.ndarray):
        chunk, valid = pad_indices(chunk, self.batch_size)
        batch = self.collate_fn(list(pool.map(self.dataset.__getitem__,
                                              chunk)))
        if self.mode != "train":
            batch["valid"] = valid
        return batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return prefetch(self._make_batch, self._chunks(), self.num_workers,
                        self.prefetch)

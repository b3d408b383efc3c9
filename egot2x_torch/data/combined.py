"""Combined multi-task loader (Lightning's ``CombinedLoader`` in
``max_size_cycle`` mode).

Counterpart of ``egot2x/data/combined.py``: the EgoT2-g tasks train on one
batch of each task a step. Each step yields ``{name: batch}``; an epoch
is as long as the longest loader, and the shorter ones start again from
their first batch when they run out.
"""

from __future__ import annotations

import itertools
from typing import Dict


class CombinedLoader:
    """Yields {name: batch} dicts; length = the longest loader's length,
    shorter loaders cycle (max_size_cycle)."""

    def __init__(self, loaders: Dict[str, object]):
        self.loaders = loaders

    def set_epoch(self, epoch: int) -> None:
        for loader in self.loaders.values():
            if hasattr(loader, "set_epoch"):
                loader.set_epoch(epoch)

    def __len__(self) -> int:
        return max(len(loader) for loader in self.loaders.values())

    def __iter__(self):
        n = len(self)
        iters = {name: iter(loader) if len(loader) >= n
                 else itertools.islice(itertools.chain.from_iterable(
                     itertools.repeat(loader)), n)
                 for name, loader in self.loaders.items()}
        for _ in range(n):
            out = {}
            for name, it in iters.items():
                try:
                    out[name] = next(it)
                except StopIteration:
                    return
            yield out

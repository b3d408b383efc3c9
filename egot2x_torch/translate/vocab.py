"""EgoT2-g label-token vocabulary for HHI.

The port's own copy of the HHI half of ``egot2x/translate/vocab.py``:
the reference builds the vocabulary with torchtext, which puts the
specials first, so the ids are ['</s>', '<unk>', 'ttm', 'lam', 'asd',
'0', '1'] and the label tokens '0' and '1' are the last two (the prompt
models' ``predict`` reads the logits of the last two ids). The HOI
vocabularies come with the HOI prompt models.
"""

from __future__ import annotations

from typing import Dict, List


class Vocab:
    """stoi / itos; a token not in it maps to ``<unk>``'s id, and a
    repeated token keeps its first id."""

    def __init__(self, tokens: List[str]):
        self.itos: List[str] = []
        self.stoi: Dict[str, int] = {}
        for t in tokens:
            if t not in self.stoi:
                self.stoi[t] = len(self.itos)
                self.itos.append(t)

    def __getitem__(self, token: str) -> int:
        return self.stoi.get(token, self.stoi["<unk>"])

    def __len__(self) -> int:
        return len(self.itos)


def build_hhi_vocab() -> Vocab:
    """['</s>', '<unk>', 'ttm', 'lam', 'asd', '0', '1'] (specials first)."""
    return Vocab(["</s>", "<unk>", "ttm", "lam", "asd", "0", "1"])

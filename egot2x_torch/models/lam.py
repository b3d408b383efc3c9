"""LAM (looking-at-me) frame trunk as a frozen token extractor.

Counterpart of ``egot2x/models/lam.py`` ``LAMTrunk``/``LAMBackbone`` with
``middle=True``: the per-frame ResNet-18 features (N, T, 256) that the
EgoT2 translators consume. The BiLSTM head of the Stage-I model is not
part of this path. The attribute is ``base_model``, as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from egot2x_torch.nn.resnet2d import ResNet2D


class LAMTrunk(nn.Module):
    """ResNet-18 per frame: (N, T, H, W, 3) -> (N, T, img_feature_dim)."""

    def __init__(self, img_feature_dim: int = 256, quant: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.img_feature_dim = img_feature_dim
        self.base_model = ResNet2D(img_feature_dim, quant, dtype)

    def forward(self, video, stem_in=None):
        """``stem_in``: the int8 stem of these frames, computed outside."""
        n, t = video.shape[:2]
        feats = self.base_model(video.reshape(n * t, *video.shape[2:]),
                                stem_in)
        return feats.reshape(n, t, self.img_feature_dim)


class LAMBackbone(LAMTrunk):
    """Frozen feature extractor for the Stage-II translators: always in
    eval mode (BN on running statistics), whatever ``train()`` is asked."""

    def train(self, mode: bool = True):
        return super().train(False)

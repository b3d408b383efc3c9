"""TTM (talking-to-me) video trunk as a frozen token extractor.

Counterpart of ``egot2x/models/ttm.py`` ``TTMTrunk``/``TTMBackbone`` with
``middle=True``: per-frame ResNet-18 features (N, T, 256). The raw audio
argument stays in the signature, as in the JAX package, and is unused on
this path (its BiLSTM and audio encoder feed only the Stage-I head). The
attribute is ``video_encoder``, as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from egot2x_torch.nn.resnet2d import ResNet2D


class TTMTrunk(nn.Module):
    """ResNet-18 per frame: (N, T, H, W, 3) -> (N, T, img_feature_dim)."""

    def __init__(self, img_feature_dim: int = 256, quant: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.img_feature_dim = img_feature_dim
        self.video_encoder = ResNet2D(img_feature_dim, quant, dtype)

    def forward(self, video, audio=None, stem_in=None):
        """``stem_in``: the int8 stem of these frames, computed outside."""
        n, t = video.shape[:2]
        feats = self.video_encoder(video.reshape(n * t, *video.shape[2:]),
                                   stem_in)
        return feats.reshape(n, t, self.img_feature_dim)


class TTMBackbone(TTMTrunk):
    """Frozen feature extractor for the Stage-II translators: always in
    eval mode (BN on running statistics), whatever ``train()`` is asked."""

    def train(self, mode: bool = True):
        return super().train(False)

"""LAM (looking-at-me) models: the frame trunk and the Stage-I classifiers.

Counterpart of ``egot2x/models/lam.py``. ``LAMTrunk`` is the per-frame
ResNet-18 (attribute ``base_model``, as in the reference): with
``middle=True`` it returns the per-frame features (N, T, 256) that the
EgoT2 translators consume (``LAMBackbone``, frozen); the Stage-I
classifiers ``BaselineLSTM`` and ``GazeLSTM`` add the 2-layer BiLSTM
(``lstm``) and take its middle frame, then ``last_layer1`` 512 -> 128 and
``last_layer2`` 128 -> 2 with no activation between. Their trunk's names
sit at the top of the model, so a Stage-I checkpoint grafts into the
translators' ``lam_model`` as it is (``core/checkpoint.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from egot2x_torch.core.registry import MODEL_REGISTRY
from egot2x_torch.nn.layers import Linear
from egot2x_torch.nn.lstm import BiLSTM
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


@MODEL_REGISTRY.register(name="BaselineLSTM")
class BaselineLSTM(LAMTrunk):
    """LAM classifier: (N, T, H, W, 3) frames -> (N, 2) logits
    of the middle frame."""

    def __init__(self, dtype=torch.float32):
        super().__init__(dtype=dtype)
        self.lstm = BiLSTM(self.img_feature_dim)
        self.last_layer1 = Linear(2 * self.img_feature_dim, 128)
        self.last_layer2 = Linear(128, 2)

    def forward(self, video):
        middle = self.lstm(super().forward(video))[:, video.shape[1] // 2]
        return self.last_layer2(self.last_layer1(middle))


@MODEL_REGISTRY.register(name="GazeLSTM")
class GazeLSTM(BaselineLSTM):
    """The Gaze360-style variant: the same graph with other weights
    (reference HHI/models/lam/model.py:99-136)."""

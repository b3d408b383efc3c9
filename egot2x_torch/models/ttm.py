"""TTM (talking-to-me) models: the video trunk and the Stage-I classifier.

Counterpart of ``egot2x/models/ttm.py``. ``TTMTrunk`` is the per-frame
ResNet-18 (attribute ``video_encoder``, as in the reference): with
``middle=True`` it returns the per-frame features (N, T, 256) that the
EgoT2 translators consume (``TTMBackbone``, frozen; the raw audio
argument stays in the signature, unused). The Stage-I classifier
``TTMBaselineLSTM`` (the reference's ``BaselineLSTM`` in ttm/model.py)
runs the 2-layer BiLSTM (``lstm``) over the frames and takes its *last*
frame, the SE-ResNet (``audio_encoder``) over the raw audio, and
``last_layer1`` 1024 -> 128, ``last_layer2`` 128 -> 2 on the two joined.
Its trunk's names sit at the top of the model, so a Stage-I checkpoint
grafts into the translators' ``ttm_model`` as it is.
"""

from __future__ import annotations

import torch
from torch import nn

from egot2x_torch.core.registry import MODEL_REGISTRY
from egot2x_torch.nn.layers import Linear
from egot2x_torch.nn.lstm import BiLSTM
from egot2x_torch.nn.resnet2d import ResNet2D
from egot2x_torch.nn.resnet_se import ResNetSE


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


@MODEL_REGISTRY.register(name="TTMBaselineLSTM")
class TTMBaselineLSTM(TTMTrunk):
    """Audio-visual TTM classifier: frames (N, T, H, W, 3) and raw 16 kHz
    audio (N, samples) -> (N, 2) logits."""

    def __init__(self, dtype=torch.float32):
        super().__init__(dtype=dtype)
        self.lstm = BiLSTM(self.img_feature_dim)
        self.audio_encoder = ResNetSE(dtype=dtype)
        self.last_layer1 = Linear(
            2 * self.img_feature_dim + self.audio_encoder.fc.out_features, 128)
        self.last_layer2 = Linear(128, 2)

    def forward(self, video, audio):
        last = self.lstm(super().forward(video))[:, -1]
        x = torch.cat([last, self.audio_encoder(audio)], dim=1)
        return self.last_layer2(self.last_layer1(x))

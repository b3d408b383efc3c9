"""SE-ResNet audio encoder with attentive-statistics pooling (ResNetSE).

Counterpart of ``egot2x/nn/resnet_se.py``, the TTM Stage-I model's audio
encoder: raw 16 kHz audio -> the log-mel frontend (``audio/melspec.py``,
outside autograd) -> a stem conv 3x3 1 -> 32 with bias, ReLU, then BN
(the reference's swapped order, kept) -> four stages of two SE basic
blocks (32/64/128/256 filters, strides 1/2/2/2; the block is TalkNet's
audio block, conv -> ReLU -> BN) -> the channel-major flatten to
(B, C*H, T') -> ASP attention (a 1x1 conv to 128, ReLU, BN on the
statistics of every batch and time step, a 1x1 conv back, softmax over
time) -> mean and standard deviation over time -> ``fc`` 512.

Module names are the reference's (HHI/models/ttm/resse.py): ``conv1``,
``bn1``, ``layer{1..4}.{0,1}``, ``attention.{0,2,3}``, ``fc``; the JAX
package's Dense attention layers are the 1x1 convs here.
"""

from __future__ import annotations

import torch
from torch import nn

from egot2x_torch.audio.melspec import resse_frontend
from egot2x_torch.nn.layers import (BatchNorm1d, BatchNorm2d, Conv1d, Conv2d,
                                    Linear)
from egot2x_torch.nn.talknet import AudioSEBlock


FILTERS = (32, 64, 128, 256)     # two SE blocks a stage
N_MELS = 64
DIM_FEAT = 512


class ResNetSE(nn.Module):
    """(B, samples) raw audio -> (B, 512)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(1, FILTERS[0], 3, 1, 1)
        self.bn1 = BatchNorm2d(FILTERS[0], eps=1e-5)
        inp = FILTERS[0]
        for stage, f in enumerate(FILTERS):
            s = 1 if stage == 0 else 2
            setattr(self, f"layer{stage + 1}", nn.Sequential(
                AudioSEBlock(inp, f, (s, s)), AudioSEBlock(f, f)))
            inp = f
        channels = FILTERS[-1] * N_MELS // 8
        self.attention = nn.Sequential(
            Conv1d(channels, 128, 1), nn.ReLU(), BatchNorm1d(128, eps=1e-5),
            Conv1d(128, channels, 1), nn.Softmax(dim=2))
        self.fc = Linear(2 * channels, DIM_FEAT)
        self.compute_dtype = dtype

    def forward(self, wave):
        mel = resse_frontend(wave)                       # (B, 64, T)
        x = mel.unsqueeze(1).to(self.compute_dtype)      # (B, 1, 64, T)
        x = self.bn1(torch.relu(self.conv1(x)))
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        x = x.flatten(1, 2)                              # (B, C*H, T')
        w = self.attention(x)
        mu = (x * w).sum(dim=2)
        var = ((x ** 2) * w).sum(dim=2) - mu ** 2
        sg = torch.sqrt(var.clamp(min=1e-5))
        return self.fc(torch.cat([mu, sg], dim=1))

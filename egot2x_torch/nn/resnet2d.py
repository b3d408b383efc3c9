"""2-D ResNet-18 frame encoder, float inference.

Counterpart of ``egot2x/nn/resnet2d.py``: a torchvision-style ResNet-18
whose head is ``fc`` 512->1000 followed by ``fc2`` 1000->num_classes with
no activation between them (the reference LAM/TTM backbones set 256).
Module names follow the reference torch model (``conv1``, ``bn1``,
``layer{1..4}.{0,1}``, ``downsample.{0,1}``, ``fc``, ``fc2``).

Frames enter NHWC, the JAX package's layout. The stem (conv1 + bn1 + ReLU
+ 3x3/2 max-pool) runs through the fused stem kernel, whose NHWC output is
the NCHW tensor the stages take in ``torch.channels_last`` memory: the
model is meant to be kept in channels_last (``build_model`` does), so no
layout copy is made anywhere in the trunk. BatchNorm epsilon is 1e-5.
"""

from __future__ import annotations

import torch
from torch import nn

from egot2x_torch.data.lam import IMAGENET_MEAN, IMAGENET_STD
from egot2x_torch.ops.stem import fold_bn, stem_pool_2d


def normalize_u8_frames(x: torch.Tensor) -> torch.Tensor:
    """ToTensor + ImageNet Normalize for integer (N..., 3) RGB frames, in
    f32; float input is returned as it is (already normalized)."""
    if x.is_floating_point():
        return x
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    return (x.float() / 255.0 - mean) / std


class BasicBlock2D(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                nn.BatchNorm2d(planes, eps=1e-5))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + identity)


class ResNet2D(nn.Module):
    """ResNet-18 (stages 2, 2, 2, 2) with the reference's fc/fc2 head."""

    def __init__(self, num_classes: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        inplanes = 64
        for stage, planes in enumerate((64, 128, 256, 512)):
            stride = 1 if stage == 0 else 2
            setattr(self, f"layer{stage + 1}", nn.Sequential(
                BasicBlock2D(inplanes, planes, stride),
                BasicBlock2D(planes, planes)))
            inplanes = planes
        self.fc = nn.Linear(512, 1000)
        self.fc2 = nn.Linear(1000, num_classes)

    def forward(self, x):
        """x (N, H, W, 3) NHWC, f32 normalized or uint8 -> (N, num_classes)."""
        bn = self.bn1
        scale, bias = fold_bn(bn.weight, bn.bias, bn.running_mean,
                              bn.running_var, bn.eps)
        x = normalize_u8_frames(x).contiguous()
        y = stem_pool_2d(x, self.conv1.weight, scale, bias)
        y = y.permute(0, 3, 1, 2)  # NCHW view of the NHWC map: channels_last
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            y = stage(y)
        return self.fc2(self.fc(y.mean((2, 3))))

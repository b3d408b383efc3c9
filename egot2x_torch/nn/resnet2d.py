"""2-D ResNet frame encoder: float inference and int8 static PTQ.

Counterpart of ``egot2x/nn/resnet2d.py``: a torchvision-style ResNet of
basic blocks, ``stage_sizes`` blocks a stage (ResNet-18's (2, 2, 2, 2) by
default; ``KeyframeCnnLSTM`` takes (3, 4, 6, 3)), whose head is ``fc``
512->1000 followed by ``fc2`` 1000->num_classes with no activation
between them (the reference LAM/TTM backbones set 256). With
``features_only=True`` the model has no head and returns the pooled 512-d
feature, as the JAX model's ``features_only`` call creates none. Module
names follow the reference torch model (``conv1``, ``bn1``,
``layer{1..4}.{i}``, ``downsample.{0,1}``, ``fc``, ``fc2``).

Frames enter NHWC, the JAX package's layout. The stem (conv1 + bn1 + ReLU
+ 3x3/2 max-pool) runs through a fused stem kernel, whose NHWC output is
the NCHW tensor the stages take in ``torch.channels_last`` memory: the
model is meant to be kept in channels_last (``build_model`` does), so no
layout copy is made anywhere in the trunk. BatchNorm epsilon is 1e-5.
With ``bn1`` in eval mode the stem folds its running statistics into the
kernel, differentiable through the kernel's backward (``ops/stem.py``),
as the Stage-II translators' trunks run. In training mode (Stage I) the
BNs normalise with batch statistics (``nn/layers.py``, flax's semantics),
which no folded kernel computes: the stem is then the library's conv,
the batch-statistics BN, ReLU and max-pool, where the JAX package runs
XLA (``egot2x/nn/resnet2d.py:269-307``).

With ``quant=True`` (inference only, after :func:`egot2x_torch.nn.quant.
calibrate`) the convs of the blocks are int8 ``QuantConv2d`` and int8
maps chain from the stem to the last block, as in ``egot2x``: the stem
quantizes before its pool (``stem_pool_q_2d``) with ``stem_act_max``;
every block but ``layer4.1`` emits ``quantize_static(out, out_act_max)``;
a block fed int8 hands it to ``conv1`` and the projection at the
upstream step and dequantizes it for the identity; ``layer4.1`` emits
the compute dtype, which the mean head reads. ``stem_in`` takes a stem
computed outside (the fused LAM + TTM stem).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from egot2x_torch.data.lam import IMAGENET_MEAN, IMAGENET_STD
from egot2x_torch.nn.layers import BatchNorm2d, Conv2d, Linear
from egot2x_torch.nn.quant import QuantConv2d, record_max
from egot2x_torch.ops.int8 import quantize_static
from egot2x_torch.ops.stem import (fold_bn, fold_bn_quant, stem_pool_2d,
                                   stem_pool_q_2d)


def normalize_u8_frames(x: torch.Tensor,
                        dtype=torch.float32) -> torch.Tensor:
    """ToTensor + ImageNet Normalize of integer (N..., 3) RGB frames,
    computed in f32 and cast to ``dtype``; float input (already
    normalized) is only cast."""
    if x.is_floating_point():
        return x.to(dtype)
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    return ((x.float() / 255.0 - mean) / std).to(dtype)


class BasicBlock2D(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 quant: bool = False, quant_out: bool = False,
                 dtype=torch.float32):
        super().__init__()
        conv = (lambda *a: QuantConv2d(*a, compute_dtype=dtype)) if quant \
            else (lambda *a: Conv2d(*a, bias=False))
        self.conv1 = conv(inplanes, planes, 3, stride, 1)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = conv(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                conv(inplanes, planes, 1, stride, 0),
                BatchNorm2d(planes, eps=1e-5))
        self.quant_out = quant_out
        if quant_out:
            self.register_buffer("out_act_max", torch.zeros(()))
        self.compute_dtype = dtype
        self.calibrating = False

    def forward(self, x):
        """The float path (also the calibration pass of a quant model)."""
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        out = torch.relu(y + identity)
        if self.quant_out and self.calibrating:
            record_max(self.out_act_max, out)
        return out

    def forward_int8(self, x, in_scale=None):
        """x in the compute dtype, or int8 at step ``in_scale`` ->
        (int8, step) when the block emits int8, else (output, None)."""
        y = torch.relu(self.bn1(self.conv1(x, in_scale)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = bn(conv(x, in_scale))
        elif x.dtype == torch.int8:
            identity = (x.float() * in_scale).to(self.compute_dtype)
        else:
            identity = x
        out = torch.relu(y + identity)
        if self.quant_out:
            return quantize_static(out, self.out_act_max)
        return out, None


class ResNet2D(nn.Module):
    """ResNet of basic blocks (ResNet-18's stages by default) with the
    reference's fc/fc2 head, or none with ``features_only``."""

    def __init__(self, num_classes: int = 3, quant: bool = False,
                 dtype=torch.float32, stage_sizes=(2, 2, 2, 2),
                 features_only: bool = False):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        self.stage_sizes = tuple(stage_sizes)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                     self.stage_sizes)):
            layer = []
            for b in range(blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                # int8 chains between blocks; the last one emits float
                last = stage == len(self.stage_sizes) - 1 and b == blocks - 1
                layer.append(BasicBlock2D(inplanes, planes, stride, quant,
                                          quant and not last, dtype))
                inplanes = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
        self.features_only = features_only
        if not features_only:
            self.fc = Linear(512, 1000)
            self.fc2 = Linear(1000, num_classes)
        self.quant = quant
        if quant:
            self.register_buffer("stem_act_max", torch.zeros(()))
        self.compute_dtype = dtype
        self.calibrating = False

    def _stages(self):
        return (self.layer1, self.layer2, self.layer3, self.layer4)

    def forward(self, x, stem_in=None):
        """x (N, H, W, 3) NHWC, f32 normalized or uint8 -> (N, num_classes)
        in the compute dtype, or the pooled (N, 512) with
        ``features_only``. ``stem_in``: (int8 pooled stem map, step) of
        the int8 path, computed outside; ``x`` is then not read."""
        if self.quant and not self.calibrating:
            y, s = stem_in if stem_in is not None else self._stem_int8(x)
            for stage in self._stages():
                for block in stage:
                    y, s = block.forward_int8(y, s)
        else:
            x = normalize_u8_frames(x, self.compute_dtype).contiguous()
            if self.bn1.training:
                y = self._stem_batch_stats(x)
            else:
                bn = self.bn1
                scale, bias = fold_bn(bn.weight, bn.bias, bn.running_mean,
                                      bn.running_var, bn.eps)
                y = stem_pool_2d(x, self.conv1.weight, scale, bias)
                if self.quant:  # calibrating; the pool keeps the map's max
                    record_max(self.stem_act_max, y)
                y = y.permute(0, 3, 1, 2)  # NCHW view of NHWC: channels_last
            for stage in self._stages():
                y = stage(y)
        y = y.mean((2, 3))
        return y if self.features_only else self.fc2(self.fc(y))

    def _stem_batch_stats(self, x):
        """The training stem on NHWC frames: conv, BN on batch statistics,
        ReLU, 3x3/2 max-pool -> NCHW in channels_last."""
        y = self.bn1(self.conv1(x.permute(0, 3, 1, 2)))
        return F.max_pool2d(torch.relu(y), 3, 2, 1)

    def _stem_int8(self, x):
        x = normalize_u8_frames(x, self.compute_dtype).contiguous()
        scale, bias, s = fold_bn_quant(self.bn1, self.stem_act_max)
        y = stem_pool_q_2d(x, self.conv1.weight, scale, bias, s)
        return y.permute(0, 3, 1, 2), s[0]

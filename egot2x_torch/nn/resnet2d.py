"""2-D ResNet-18 frame encoder: float inference and int8 static PTQ.

Counterpart of ``egot2x/nn/resnet2d.py``: a torchvision-style ResNet-18
whose head is ``fc`` 512->1000 followed by ``fc2`` 1000->num_classes with
no activation between them (the reference LAM/TTM backbones set 256).
Module names follow the reference torch model (``conv1``, ``bn1``,
``layer{1..4}.{0,1}``, ``downsample.{0,1}``, ``fc``, ``fc2``).

Frames enter NHWC, the JAX package's layout. The stem (conv1 + bn1 + ReLU
+ 3x3/2 max-pool) runs through a fused stem kernel, whose NHWC output is
the NCHW tensor the stages take in ``torch.channels_last`` memory: the
model is meant to be kept in channels_last (``build_model`` does), so no
layout copy is made anywhere in the trunk. BatchNorm epsilon is 1e-5.
The stem folds ``bn1``'s running statistics, so the trunk runs with its
BNs in eval mode (a ``bn1`` in training mode raises: Stage-I training,
with batch statistics, is not ported). With eval BNs the float path is
differentiable, the stem through its kernel's backward (``ops/stem.py``).

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
from torch import nn

from egot2x_torch.data.lam import IMAGENET_MEAN, IMAGENET_STD
from egot2x_torch.nn.layers import Conv2d, Linear
from egot2x_torch.nn.quant import QuantConv2d, record_max
from egot2x_torch.ops.int8 import quantize_static
from egot2x_torch.ops.stem import (check_eval_bn, fold_bn, fold_bn_quant,
                                   stem_pool_2d, stem_pool_q_2d)


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
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv2 = conv(planes, planes, 3, 1, 1)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                conv(inplanes, planes, 1, stride, 0),
                nn.BatchNorm2d(planes, eps=1e-5))
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
    """ResNet-18 (stages 2, 2, 2, 2) with the reference's fc/fc2 head."""

    def __init__(self, num_classes: int = 3, quant: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        inplanes = 64
        for stage, planes in enumerate((64, 128, 256, 512)):
            stride = 1 if stage == 0 else 2
            last = stage == 3
            setattr(self, f"layer{stage + 1}", nn.Sequential(
                BasicBlock2D(inplanes, planes, stride, quant, quant, dtype),
                BasicBlock2D(planes, planes, 1, quant, quant and not last,
                             dtype)))
            inplanes = planes
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
        in the compute dtype. ``stem_in``: (int8 pooled stem map, step) of
        the int8 path, computed outside; ``x`` is then not read."""
        if self.quant and not self.calibrating:
            y, s = stem_in if stem_in is not None else self._stem_int8(x)
            for stage in self._stages():
                for block in stage:
                    y, s = block.forward_int8(y, s)
        else:
            bn = self.bn1
            check_eval_bn(bn)
            scale, bias = fold_bn(bn.weight, bn.bias, bn.running_mean,
                                  bn.running_var, bn.eps)
            x = normalize_u8_frames(x, self.compute_dtype).contiguous()
            y = stem_pool_2d(x, self.conv1.weight, scale, bias)
            if self.quant:  # calibrating; the pool keeps the map's max
                record_max(self.stem_act_max, y)
            y = y.permute(0, 3, 1, 2)  # NCHW view of NHWC: channels_last
            for stage in self._stages():
                y = stage(y)
        return self.fc2(self.fc(y.mean((2, 3))))

    def _stem_int8(self, x):
        x = normalize_u8_frames(x, self.compute_dtype).contiguous()
        scale, bias, s = fold_bn_quant(self.bn1, self.stem_act_max)
        y = stem_pool_q_2d(x, self.conv1.weight, scale, bias, s)
        return y.permute(0, 3, 1, 2), s[0]

"""TalkNet audio-visual active-speaker backbone: float and int8 inference.

Counterpart of ``egot2x/nn/talknet.py``. Module names follow the reference
torch model (``visualFrontend.frontend3D``, ``visualFrontend.resnet``,
``visualTCN.net``, ``visualConv1D.net``, ``audioEncoder``, ``crossA2V``,
``crossV2A``, ``selfAV``), so reference checkpoints load as they are.

Where the port matches ``egot2x`` rather than the reference or torch
defaults:
  * the 3D stem pads time per sample: each clip gets its own temporal
    zero-pad of 2 (the reference flattens B*T and leaks frames across
    clips; PARITY.md). It runs through the fused stem kernel;
  * grey input is normalized ``(x / 255 - 0.4161) / 0.1688`` whatever its
    dtype, float [0, 255] included;
  * BatchNorm epsilon is 1e-3 in the stem BN and the AVSR layers, 1e-5 in
    the TCN, the conv1D head and the SE audio encoder; LayerNorm is 1e-6;
  * the SE audio block runs conv -> ReLU -> BN;
  * the cross-attention residual lands on ``src``;
  * audio and video are cut to the shorter of their two lengths.

  * BatchNorm momentum is flax's: 0.99 (torch's 0.01) in the stem BN and
    the AVSR layers, 0.9 (torch's 0.1) elsewhere, with the batch
    statistics of ``nn/layers.py`` in training mode.

With the stem BN in eval mode the 3D stem folds its running statistics
into the fused stem kernel, as the translators' ``FrozenTalkNet`` always
runs (its parameters still take gradients when its owner trains it,
``nofreeze``). In training mode (Stage-I ``TalkNetWithHeads``) the stem
is the JAX package's training branch: the unpacked 3D conv, the BN on
batch statistics, ReLU and the max-pool, as library ops; the conv runs as
a 2D conv over each frame's 5 temporal taps (the same sums), whose weight
gradient cuDNN takes in 2.65 ms against the 3D conv's 87.6 ms with one
input channel (480 frames of 112^2, f32, an H100 80GB HBM3 at 700 W).
Dropout (rate 0.1) acts in training mode at the JAX sites of the
attention layers: the attention probabilities, the attention residual,
the FFN's hidden layer and its output.

With ``quant=True`` (inference only, after :func:`egot2x_torch.nn.quant.
calibrate`) the visual ResNet runs int8 as in ``egot2x``: the 3D stem
quantizes before its pool (``stem_pool_q_3d``) with ``stem_act_max``, the
AVSR layers' convs (the 1x1 ``downsample`` too) are ``QuantConv2d``,
layers 1-3 emit int8 with their ``out_act_max`` and layer 4 the compute
dtype. The audio encoder, TCN, conv1D and attention stay float, in the
compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from egot2x_torch.nn.common import Dropout, MultiHeadAttention, layer_norm
from egot2x_torch.nn.layers import (BatchNorm1d, BatchNorm2d, BatchNorm3d,
                                    Conv1d, Conv2d, Linear, PReLU)
from egot2x_torch.nn.quant import QuantConv2d, record_max
from egot2x_torch.ops.int8 import quantize_static
from egot2x_torch.ops.stem import (fold_bn, fold_bn_quant, frame_taps,
                                   stem_pool_3d, stem_pool_q_3d)

AVSR_BN_EPS = 1e-3
AVSR_BN_MOMENTUM = 0.01   # torch's; flax's 0.99
ATTENTION_DROPOUT = 0.1


class AVSRResNetLayer(nn.Module):
    """Two-block residual layer of the AVSR visual ResNet."""

    def __init__(self, inplanes: int, planes: int, stride: int,
                 quant: bool = False, quant_out: bool = False,
                 dtype=torch.float32):
        super().__init__()
        bn = lambda: BatchNorm2d(planes, eps=AVSR_BN_EPS,
                                 momentum=AVSR_BN_MOMENTUM)
        conv = (lambda *a: QuantConv2d(*a, compute_dtype=dtype)) if quant \
            else (lambda *a: Conv2d(*a, bias=False))
        conv3 = lambda i, s: conv(i, planes, 3, s, 1)
        self.conv1a = conv3(inplanes, stride)
        self.bn1a = bn()
        self.conv2a = conv3(planes, 1)
        # the 1x1 projection exists only where the layer strides, as in
        # the JAX package
        self.downsample = (conv(inplanes, planes, 1, stride, 0)
                           if stride != 1 else None)
        self.outbna = bn()
        self.conv1b = conv3(planes, 1)
        self.bn1b = bn()
        self.conv2b = conv3(planes, 1)
        self.outbnb = bn()
        self.quant_out = quant_out
        if quant_out:
            self.register_buffer("out_act_max", torch.zeros(()))
        self.compute_dtype = dtype
        self.calibrating = False

    def _tail(self, y):
        z = torch.relu(self.outbna(y))
        z = self.conv2b(torch.relu(self.bn1b(self.conv1b(z))))
        return torch.relu(self.outbnb(z + y))

    def forward(self, x):
        """The float path (also the calibration pass of a quant model)."""
        y = self.conv2a(torch.relu(self.bn1a(self.conv1a(x))))
        y = y + (x if self.downsample is None else self.downsample(x))
        out = self._tail(y)
        if self.quant_out and self.calibrating:
            record_max(self.out_act_max, out)
        return out

    def forward_int8(self, x, in_scale=None):
        """x in the compute dtype, or int8 at step ``in_scale`` ->
        (int8, step) when the layer emits int8, else (output, None)."""
        y = self.conv2a(torch.relu(self.bn1a(self.conv1a(x, in_scale))))
        if self.downsample is not None:
            y = y + self.downsample(x, in_scale)
        elif x.dtype == torch.int8:
            y = y + (x.float() * in_scale).to(self.compute_dtype)
        else:
            y = y + x
        out = self._tail(y)
        if self.quant_out:
            return quantize_static(out, self.out_act_max)
        return out, None


class VisualFrontend(nn.Module):
    """(B, T, H, W) grey in [0, 255] -> (B, T, 512)."""

    def __init__(self, quant: bool = False, dtype=torch.float32):
        super().__init__()
        # Sequential for the reference names frontend3D.{0,1}; forward runs
        # conv, BN, ReLU and pool as one fused stem kernel
        self.frontend3D = nn.Sequential(
            nn.Conv3d(1, 64, (5, 7, 7), (1, 2, 2), (2, 3, 3), bias=False),
            BatchNorm3d(64, eps=AVSR_BN_EPS, momentum=AVSR_BN_MOMENTUM))
        layers = [(64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2)]
        self.resnet = nn.Sequential()
        for i, (inp, out, stride) in enumerate(layers):
            self.resnet.add_module(f"layer{i + 1}", AVSRResNetLayer(
                inp, out, stride, quant, quant and i < 3, dtype))
        self.quant = quant
        if quant:
            self.register_buffer("stem_act_max", torch.zeros(()))
        self.compute_dtype = dtype
        self.calibrating = False

    def forward(self, x):
        b, t = x.shape[:2]
        x = ((x.to(self.compute_dtype) / 255.0 - 0.4161) / 0.1688).contiguous()
        conv, bn = self.frontend3D
        if self.quant and not self.calibrating:
            scale, bias, s = fold_bn_quant(bn, self.stem_act_max)
            y = stem_pool_q_3d(x, conv.weight, scale, bias, s)
            y, s = y.permute(0, 3, 1, 2), s[0]         # channels_last
            for layer in self.resnet:
                y, s = layer.forward_int8(y, s)
        elif bn.training:
            y = self.resnet(self._stem_batch_stats(x))
        else:
            scale, bias = fold_bn(bn.weight, bn.bias, bn.running_mean,
                                  bn.running_var, bn.eps)
            y = stem_pool_3d(x, conv.weight, scale, bias)  # (B*T, H/4, W/4, 64)
            if self.quant:  # calibrating; the pool keeps the map's max
                record_max(self.stem_act_max, y)
            y = self.resnet(y.permute(0, 3, 1, 2))         # channels_last
        return y.mean((2, 3)).reshape(b, t, 512)

    def _stem_batch_stats(self, x):
        """The training stem on (B, T, H, W) clips: the 5x7x7 conv as a 2D
        conv over each frame's temporal taps, BN on the batch statistics of
        every frame's map, ReLU, 3x3/2 max-pool -> (B*T, 64, H/4, W/4)."""
        conv, bn = self.frontend3D
        taps = frame_taps(x).to(x.dtype).permute(0, 3, 1, 2)
        w = conv.weight.to(x.dtype).flatten(1, 2)            # (64, 5, 7, 7)
        y = F.conv2d(taps, w, stride=2, padding=3)            # (B*T, 64, ...)
        y = bn(y.unsqueeze(2)).squeeze(2)   # BatchNorm3d: (N, C, 1, H, W)
        return F.max_pool2d(torch.relu(y), 3, 2, 1)


class GlobalLayerNorm(nn.Module):
    """gLN over (C, T) jointly with a per-channel affine, on (B, C, T)."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, channels, 1))
        self.beta = nn.Parameter(torch.zeros(1, channels, 1))

    def forward(self, y):
        mean = y.mean(dim=(1, 2), keepdim=True)
        var = ((y - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        return (self.gamma.to(y.dtype) * (y - mean) / torch.sqrt(var + 1e-8)
                + self.beta.to(y.dtype))


class DSConv1d(nn.Module):
    """Residual depthwise-separable temporal conv block on (B, C, T)."""

    def __init__(self, channels: int = 512):
        super().__init__()
        self.net = nn.Sequential(
            nn.ReLU(), BatchNorm1d(channels, eps=1e-5),
            Conv1d(channels, channels, 3, 1, 1, groups=channels, bias=False),
            PReLU(), GlobalLayerNorm(channels),
            Conv1d(channels, channels, 1, bias=False))

    def forward(self, x):
        return self.net(x) + x


class VisualTCN(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = nn.Sequential(*[DSConv1d(512) for _ in range(5)])

    def forward(self, x):
        return self.net(x)


class VisualConv1D(nn.Module):
    """512 -> 128 temporal conv head on (B, C, T)."""

    def __init__(self):
        super().__init__()
        self.net = nn.Sequential(
            Conv1d(512, 256, 5, 1, 2), BatchNorm1d(256, eps=1e-5),
            nn.ReLU(), Conv1d(256, 128, 1))

    def forward(self, x):
        return self.net(x)


class _SqueezeExcite(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Sequential(
            Linear(channels, channels // 8), nn.ReLU(),
            Linear(channels // 8, channels), nn.Sigmoid())

    def forward(self, y):
        return y * self.fc(y.mean((2, 3)))[:, :, None, None]


class AudioSEBlock(nn.Module):
    """SE basic block in the reference's conv -> ReLU -> BN order."""

    def __init__(self, inplanes: int, planes: int, stride=(1, 1)):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.se = _SqueezeExcite(planes)
        self.downsample = None
        if tuple(stride) != (1, 1) or inplanes != planes:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes, 1, stride, bias=False),
                BatchNorm2d(planes, eps=1e-5))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.bn1(torch.relu(self.conv1(x)))
        y = self.se(self.bn2(self.conv2(y)))
        return torch.relu(y + residual)


class AudioEncoder(nn.Module):
    """(B, 4T, 13) MFCC -> (B, T, 128): SE-ResNet [3, 4, 6, 3] x filters
    [16, 32, 64, 128] over (B, 1, 13 freq, 4T time); stem stride (2, 1),
    stages 2 and 3 stride 2; the output is the mean over frequency."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(1, 16, 7, (2, 1), 3, bias=False)
        self.bn1 = BatchNorm2d(16, eps=1e-5)
        strides = [(1, 1), (2, 2), (2, 2), (1, 1)]
        inp = 16
        for i, (f, n, s) in enumerate(zip((16, 32, 64, 128), (3, 4, 6, 3),
                                          strides)):
            blocks = [AudioSEBlock(inp, f, s)]
            blocks += [AudioSEBlock(f, f) for _ in range(n - 1)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            inp = f
        self.compute_dtype = dtype

    def forward(self, mfcc):
        x = mfcc.transpose(1, 2).unsqueeze(1).to(self.compute_dtype)
        # x: (B, 1, 13, 4T)
        x = torch.relu(self.bn1(self.conv1(x)))
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        return x.mean(dim=2).transpose(1, 2)            # (B, T, C)


class CrossAttentionLayer(nn.Module):
    """Post-LN block: MHA(query=tar, key=src, value=src) + 4x FFN; the
    attention residual lands on ``src``. In training mode dropout acts on
    the attention probabilities, the attention output, the FFN's hidden
    layer and its output."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, num_heads,
                                            ATTENTION_DROPOUT)
        self.linear1 = Linear(d_model, d_model * 4)
        self.linear2 = Linear(d_model * 4, d_model)
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.dropout, self.dropout1, self.dropout2 = (
            Dropout(ATTENTION_DROPOUT) for _ in range(3))

    def forward(self, src, tar):
        x = self.norm1(src + self.dropout1(self.self_attn(tar, src, src)))
        h = self.dropout(torch.relu(self.linear1(x)))
        return self.norm2(x + self.dropout2(self.linear2(h)))


class TalkNetModel(nn.Module):
    """Full TalkNet backbone: per-frame features outsAV (B, T, 256),
    outsA (B, T, 128) and outsV (B, T, 128)."""

    def __init__(self, quant: bool = False, dtype=torch.float32):
        super().__init__()
        self.visualFrontend = VisualFrontend(quant, dtype)
        self.visualTCN = VisualTCN()
        self.visualConv1D = VisualConv1D()
        self.audioEncoder = AudioEncoder(dtype)
        self.crossA2V = CrossAttentionLayer(128, 8)
        self.crossV2A = CrossAttentionLayer(128, 8)
        self.selfAV = CrossAttentionLayer(256, 8)

    def forward_visual_frontend(self, faces):
        x = self.visualFrontend(faces).transpose(1, 2)  # (B, 512, T)
        return self.visualConv1D(self.visualTCN(x)).transpose(1, 2)

    def forward(self, mfcc, faces):
        """mfcc (B, 4T, 13), faces (B, T, H, W) grey in [0, 255]."""
        audio = self.audioEncoder(mfcc)
        visual = self.forward_visual_frontend(faces)
        t = min(audio.shape[1], visual.shape[1])
        audio, visual = audio[:, :t], visual[:, :t]
        x1 = self.crossA2V(src=audio, tar=visual)
        x2 = self.crossV2A(src=visual, tar=audio)
        av = torch.cat([x1, x2], dim=2)
        return self.selfAV(src=av, tar=av), x1, x2


class FrozenTalkNet(TalkNetModel):
    """TalkNet as a Stage-II translator's ``asd_model``: always in eval
    mode (BN on running statistics, no dropout), whatever ``train()`` is
    asked, as the JAX translators run it with ``train=False`` and
    ``deterministic=True``. Its parameters take gradients where the owner
    differentiates it (``nofreeze``). Stage-I ASD trains ``TalkNetModel``
    itself."""

    def train(self, mode: bool = True):
        return super().train(False)

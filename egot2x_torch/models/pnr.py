"""PNR/OSCC Stage-I models: inference on the card.

Counterpart of ``egot2x/models/pnr.py``:

  * ``KeyframeLocalizationResNet``: the ``slow_layer5`` ResNet3D-50 trunk
    and a per-frame ``KeyframeLocalizationHead`` -> (B, T, 1) keyframe
    logits (the PNR task takes ``[..., 0]``); ``middle=True`` returns the
    per-frame tokens, (B, 16, 8192) at crop 225.
  * ``StateChangeClsResNet``: the same trunk, the head pooled over the
    whole T' -> (B, 2) state-change logits (``out[:, 0]``); with
    ``no_temp_pool`` a per-frame head whose logits are averaged over the
    frames; ``middle=True`` returns the head's tokens.
  * ``DualHeadResNet``: both heads on one trunk (``keyframe_head``,
    ``state_head``) -> ((B, T) keyframe logits, (B, 2) state logits).
  * ``KeyframeCnnLSTM``: a ResNet of basic blocks with stages (3, 4, 6, 3)
    per frame (``backbone``, its 512-d pooled feature), a one-layer BiLSTM
    of 512 (``lstm``), ``regressor`` 1024 -> 1 and a sigmoid -> (B, T)
    keyframe scores.

Frames are (B, T, H, W, 3) NTHWC. The ResNet3D models take raw [0, 255]
pixels (``input_norm=None``: uint8 frames are only cast, as the reference
PNR pipeline feeds unnormalised frames); ``KeyframeCnnLSTM``'s 2D trunk
takes float frames as they are and ImageNet-normalises uint8 ones
(``nn/resnet2d.py``), as the JAX package's does. On the card its 2D stem
runs through the stem kernel (``ops/stem.py::stem_pool_2d``): one launch
a forward covers all B T frames. The heads' spatial pool is crop_size //
32 (7 at 225). Parameter names are the JAX package's (``trunk``,
``head``; ``backbone``, ``lstm``, ``regressor``). ``quant=True`` gives
``KeyframeLocalizationResNet`` and ``StateChangeClsResNet`` the int8 trunk
(``nn/resnet3d.py``; calibrate it with ``nn/quant.py::calibrate``);
``DualHeadResNet`` and ``KeyframeCnnLSTM`` take no ``quant``, as their JAX
classes have none.
"""

from __future__ import annotations

import torch
from torch import nn

from egot2x_torch.core.registry import MODEL_REGISTRY
from egot2x_torch.nn.layers import Linear
from egot2x_torch.nn.lstm import BiLSTM
from egot2x_torch.nn.resnet2d import ResNet2D
from egot2x_torch.nn.resnet3d import (POOL1, KeyframeLocalizationHead,
                                      ResNet3D, head_tokens)

TRUNK_CHANNELS = 2048   # res5 of the ResNet3D-50 / -101 trunks


def _head_spatial_pool(crop_size: int, arch: str) -> int:
    return crop_size // 32 // POOL1[arch][1]


class _PnrResNet(nn.Module):
    """The trunk the ResNet3D models share, and their head's geometry."""

    def __init__(self, arch, depth, crop_size, remat, nonlocal_cfg, quant,
                 dtype):
        super().__init__()
        self.trunk = ResNet3D(arch=arch, depth=depth, remat=remat,
                              input_norm=None, nonlocal_cfg=nonlocal_cfg,
                              quant=quant, dtype=dtype)
        self.spatial_pool = _head_spatial_pool(crop_size, arch)
        self.tokens = head_tokens(TRUNK_CHANNELS, crop_size,
                                  self.spatial_pool)


@MODEL_REGISTRY.register(name="KeyframeLocalizationResNet")
class KeyframeLocalizationResNet(_PnrResNet):
    """Per-frame keyframe logits (B, T, num_classes); ``middle=True`` ->
    the per-frame tokens."""

    def __init__(self, arch: str = "slow_layer5", depth: int = 50,
                 crop_size: int = 225, num_classes: int = 1,
                 dropout_rate: float = 0.5, remat: bool = False,
                 nonlocal_cfg=None, quant: bool = False,
                 dtype=torch.float32):
        super().__init__(arch, depth, crop_size, remat, nonlocal_cfg, quant,
                         dtype)
        self.head = KeyframeLocalizationHead(
            self.tokens, num_classes, self.spatial_pool, dropout_rate)

    def forward(self, frames, middle: bool = False):
        return self.head(self.trunk(frames), middle=middle)


@MODEL_REGISTRY.register(name="StateChangeClsResNet")
class StateChangeClsResNet(_PnrResNet):
    """2-class state-change logits (B, 2); ``no_temp_pool`` keeps a
    per-frame head and averages its logits over the frames."""

    def __init__(self, arch: str = "slow_layer5", depth: int = 50,
                 crop_size: int = 225, num_frames: int = 16,
                 num_classes: int = 2, no_temp_pool: bool = False,
                 dropout_rate: float = 0.5, remat: bool = False,
                 nonlocal_cfg=None, quant: bool = False,
                 dtype=torch.float32):
        super().__init__(arch, depth, crop_size, remat, nonlocal_cfg, quant,
                         dtype)
        self.no_temp_pool = no_temp_pool
        self.head = KeyframeLocalizationHead(
            self.tokens, num_classes, self.spatial_pool, dropout_rate)

    def forward(self, frames, middle: bool = False):
        y = self.trunk(frames)
        out = self.head(y, middle=middle,
                        temporal_pool=1 if self.no_temp_pool else y.shape[2])
        if middle:
            return out               # (B, T', tokens)
        if not self.no_temp_pool:
            return out[:, 0, :]      # the one position of the full pool
        return out.mean(dim=1)       # logits averaged over the frames


@MODEL_REGISTRY.register(name="DualHeadResNet")
class DualHeadResNet(_PnrResNet):
    """Keyframe and state-change heads on one trunk -> ((B, T), (B, 2))."""

    def __init__(self, arch: str = "slow_layer5", depth: int = 50,
                 crop_size: int = 225, num_frames: int = 16,
                 dropout_rate: float = 0.5, nonlocal_cfg=None,
                 dtype=torch.float32):
        super().__init__(arch, depth, crop_size, False, nonlocal_cfg, False,
                         dtype)
        self.keyframe_head = KeyframeLocalizationHead(
            self.tokens, 1, self.spatial_pool, dropout_rate)
        self.state_head = KeyframeLocalizationHead(
            self.tokens, 2, self.spatial_pool, dropout_rate)

    def forward(self, frames):
        y = self.trunk(frames)
        keyframe = self.keyframe_head(y)
        state = self.state_head(y, temporal_pool=y.shape[2])
        return keyframe[..., 0], state[:, 0, :]


@MODEL_REGISTRY.register(name="KeyframeCnnLSTM")
class KeyframeCnnLSTM(nn.Module):
    """Per-frame 2D ResNet (3, 4, 6, 3) + BiLSTM -> sigmoid per-frame
    keyframe scores (B, T)."""

    def __init__(self, hidden_size: int = 512, dtype=torch.float32):
        super().__init__()
        self.backbone = ResNet2D(stage_sizes=(3, 4, 6, 3), features_only=True,
                                 dtype=dtype)
        self.lstm = BiLSTM(hidden_size, num_layers=1, input_size=512)
        self.regressor = Linear(2 * hidden_size, 1)

    def forward(self, frames):
        b, t = frames.shape[:2]
        feats = self.backbone(frames.reshape(b * t, *frames.shape[2:]))
        y = self.lstm(feats.reshape(b, t, -1))
        return torch.sigmoid(self.regressor(y)[..., 0])

"""Two-pathway SlowFast network and its multi-task head.

Counterpart of ``egot2x/nn/slowfast.py``:

  * ``FuseFastToSlow``: the lateral conv ``conv_f2s`` (k x 1 x 1, stride
    (alpha, 1, 1), padding k // 2 on T, C -> 2 C, no bias), BN and ReLU on
    the fast map, concatenated to the slow map on the channel axis. With
    the fast pathway's T = alpha T_slow its output is T_slow long (32 -> 8
    at alpha 4, 32 -> 4 at alpha 8).
  * ``SlowFast``: the two stems (``s1_slow`` 1x7x7 to ``width``, ``s1_fast``
    5x7x7 to ``width // beta_inv``), then res2..res5 of each pathway
    (``s{i}_slow``, ``s{i}_fast``, ``nn/resnet3d.py::ResStage``) with a fuse
    (``s{i}_fuse``) after s1..s4. The temporal kernels are the reference's
    ``_TEMPORAL_KERNEL_BASIS["slowfast"]``: 1 on the slow pathway up to
    res3 and 3 from res4, 3 on the fast pathway (5 at its stem); the first
    ``num_block_temp_kernel`` blocks of a stage take them, the rest 1.
    PyTorch wants the channel counts the JAX package infers: after each
    fuse the slow pathway carries ``dim + 2 dim / beta_inv`` channels (80,
    320, 640, 1280 into res2..res5 at width 64, beta_inv 8), the fast one
    8, 32, 64, 128 and 256.
  * ``MultiTaskHead``: each pathway's global (T, H, W) mean, concatenated
    (2048 + 256), dropout, then one ``projection_{i}`` a head, logits at
    eval (the JAX head's default ``test_noact=True``; its eval softmax with
    ``test_noact=False`` is not ported: no model asks for it).

Inputs follow the JAX package: a list ``[slow (B, T / alpha, H, W, 3),
fast (B, T, H, W, 3)]`` of NTHWC frames. Integer frames are normalised in
the stems, ``(x / 255 - 0.45) / 0.225``; float frames are taken as they
are. The trunk runs NCTHW in ``torch.channels_last_3d`` memory as
``ResNet3D`` does, and returns the two res5 maps NCTHW: (B, 2048, T /
alpha, H / 32, W / 32) and (B, 256, T, H / 32, W / 32). Parameter names
are the JAX package's, so the weight bridge pairs module paths. The int8
trunk (``quant``) is not ported: ``quant=True`` raises.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from egot2x_torch.nn.common import Dropout
from egot2x_torch.nn.layers import Linear
from egot2x_torch.nn.resnet3d import (MODEL_STAGE_DEPTH, QUANT_NOT_PORTED,
                                      ResStage, VideoStem, _bn, _Conv)

# conv1 + res2..res5 temporal kernels, [slow, fast] each (the reference's
# _TEMPORAL_KERNEL_BASIS["slowfast"])
TEMPORAL_KERNELS = [[[1], [5]], [[1], [3]], [[1], [3]], [[3], [3]],
                    [[3], [3]]]
# the JAX module's defaults, which no model of either package changes
WIDTH, FUSION_RATIO, FUSION_KERNEL = 64, 2, 5
SPATIAL_STRIDES, NUM_BLOCK_TEMP_KERNEL = (1, 2, 2, 2), (3, 4, 6, 3)
# the head's dropout rate, the JAX default: an identity in eval, and the
# port's SlowFast models run in eval only
HEAD_DROPOUT = 0.5


class FuseFastToSlow(nn.Module):
    def __init__(self, dim_in: int, alpha: int = 8):
        super().__init__()
        k, dim_out = FUSION_KERNEL, dim_in * FUSION_RATIO
        self.conv_f2s = _Conv(dim_in, dim_out, (k, 1, 1), (alpha, 1, 1),
                              padding=(k // 2, 0, 0), bias=False)
        self.bn = _bn(dim_out)

    def forward(self, slow, fast):
        fuse = torch.relu(self.bn(self.conv_f2s(fast)))
        return torch.cat([slow, fuse], dim=1), fast


class SlowFast(nn.Module):
    """Trunk: ``[slow, fast]`` NTHWC frames -> ``[slow_s5, fast_s5]``
    NCTHW (channels_last_3d)."""

    def __init__(self, depth: int = 50, beta_inv: int = 8, alpha: int = 8,
                 quant: bool = False, dtype=torch.float32):
        super().__init__()
        if quant:
            raise NotImplementedError(QUANT_NOT_PORTED)
        w, tk = WIDTH, TEMPORAL_KERNELS
        slow_dims = (w, w * 4, w * 8, w * 16, w * 32)
        fast_dims = tuple(d // beta_inv for d in slow_dims)
        # a fuse adds FUSION_RATIO x the fast pathway's channels to the slow
        slow_in = tuple(s + FUSION_RATIO * f
                        for s, f in zip(slow_dims, fast_dims))
        self.s1_slow = VideoStem(3, w, tk[0][0][0], dtype=dtype)
        self.s1_fast = VideoStem(3, fast_dims[0], tk[0][1][0], dtype=dtype)
        for i, blocks in enumerate(MODEL_STAGE_DEPTH[depth]):
            inner = w * 2 ** i
            setattr(self, f"s{i + 1}_fuse", FuseFastToSlow(fast_dims[i],
                                                           alpha))
            for path, din, dout, dinner, kernels in (
                    ("slow", slow_in[i], slow_dims[i + 1], inner,
                     tk[i + 1][0]),
                    ("fast", fast_dims[i], fast_dims[i + 1],
                     inner // beta_inv, tk[i + 1][1])):
                setattr(self, f"s{i + 2}_{path}", ResStage(
                    din, dout, dinner, blocks, kernels,
                    NUM_BLOCK_TEMP_KERNEL[i], SPATIAL_STRIDES[i]))

    def forward(self, pathways):
        slow_in, fast_in = pathways
        slow, fast = self.s1_slow(slow_in), self.s1_fast(fast_in)
        for i in range(1, 5):
            slow, fast = getattr(self, f"s{i}_fuse")(slow, fast)
            slow = getattr(self, f"s{i + 1}_slow")(slow)
            fast = getattr(self, f"s{i + 1}_fast")(fast)
        return [slow, fast]


class MultiTaskHead(nn.Module):
    """Both pathways' global means, concatenated, one projection a head ->
    a list of (B, n) outputs."""

    def __init__(self, dim_in: int, num_classes: Sequence[int]):
        super().__init__()
        self.num_heads = len(num_classes)
        self.dropout = Dropout(HEAD_DROPOUT)
        for i, n in enumerate(num_classes):
            setattr(self, f"projection_{i}", Linear(dim_in, n))

    def forward(self, pathways):
        x = self.dropout(torch.cat([p.mean((2, 3, 4)) for p in pathways],
                                   dim=1))
        return [getattr(self, f"projection_{i}")(x)
                for i in range(self.num_heads)]

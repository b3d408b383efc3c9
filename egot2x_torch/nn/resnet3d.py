"""PySlowFast-style single-pathway 3D ResNet, its Nonlocal block and the
PNR heads.

Counterpart of ``egot2x/nn/resnet3d.py``: the temporal-kernel tables per
architecture (``TEMPORAL_KERNEL_BASIS``, ``POOL1``), the bottleneck
(``BottleneckTransform``: a Tx1x1 conv padding T by T // 2, then the
1x3x3 conv that carries the spatial stride, then 1x1x1), ``ResBlock``
(``branch1`` projection where the width or the stride changes),
``ResStage`` (the temporal kernel cycles over ``temp_kernel_sizes`` for
the first ``num_block_temp_kernel`` blocks and is 1 after them; a
``Nonlocal`` after the blocks ``resolve_nonlocal`` names, with T folded
into the batch for ``nonlocal_group`` > 1), ``VideoStem`` (Tx7x7 conv
stride (1, 2, 2), BN, ReLU and a 3x3/2 pad-1 max-pool of each frame),
``ResNet3D`` (the stem, res2..res5 and the VALID temporal max-pool after
res2 of c2d and i3d), and the heads ``KeyframeLocalizationHead`` and
``ResNetBasicHead``.

Frames enter NTHWC, as the JAX package takes them. The trunk runs NCTHW
in ``torch.channels_last_3d`` memory, which the NTHWC frames already are
(``x.permute(0, 4, 1, 2, 3)`` is a view), so no layout copy is made:
``build_model`` keeps the convs' weights in that format. The trunk returns
(B, 2048, T', H', W'). Module names are the JAX package's (``s1.conv``,
``s2.block0.branch2.a_bn``, ``s3.nonlocal1.conv_theta``, ``projection``),
so the weight bridge pairs them path for path.

Integer frames: with ``input_norm=None`` (the PNR family's raw [0, 255]
pixels) they are only cast to the compute dtype; with ``(mean, std)``
they are normalised, ``(x / 255 - mean) / std`` in f32, before the stem
conv. The JAX package can fold that affine into the conv instead
(``_VideoStemConv``, a layout trick of its TPU stems): the function is the
same. Float frames are taken as they are. BatchNorm: eps 1e-5, flax's
momentum 0.9 (torch's 0.1, ``nn/layers.py``); the Nonlocal's BN starts at
a zero scale, so a fresh block is the identity. The video stem is the
library's conv, BN, ReLU and pool, as the JAX package runs it in XLA: the
stem kernel (``ops/stem.py``) takes the 7x7 2D and TalkNet's 1-channel
5x7x7 stems only. The Nonlocal's affinity is a batched ``torch.matmul``,
as the JAX package's is an einsum outside any Pallas kernel. ``remat``
is accepted and changes nothing: these models run inference only.

``quant=True`` is the JAX package's int8 static-PTQ trunk: the stage convs
(each bottleneck's ``a``, ``b`` and ``c`` and each ``branch1``) are
``nn/quant.py::QuantConv3d``; the video stem, the Nonlocals and the heads
stay float, as in the JAX package. Such a trunk needs
``nn/quant.py::calibrate`` (or calibrated scales in what it loads), and an
uncalibrated forward raises.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from egot2x_torch.nn.common import Dropout
from egot2x_torch.nn.layers import BatchNorm3d, Conv3d, Linear
from egot2x_torch.nn.quant import ChecksCalibration, QuantConv3d

MODEL_STAGE_DEPTH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

# conv1 + res2..res5 temporal kernels per architecture
TEMPORAL_KERNEL_BASIS = {
    "c2d": [[1], [1], [1], [1], [1]],
    "c2d_nopool": [[1], [1], [1], [1], [1]],
    "i3d": [[5], [3], [3, 1], [3, 1], [1, 3]],
    "i3d_nopool": [[5], [3], [3, 1], [3, 1], [1, 3]],
    "slow": [[1], [1], [1], [3], [3]],
    "slow_layer3": [[1], [1], [3], [3], [3]],
    "slow_layer4": [[1], [3], [3], [3], [3]],
    "slow_layer5": [[3], [3], [3], [3], [3]],
}

# post-res2 temporal pool per architecture
POOL1 = {
    "c2d": (2, 1, 1),
    "c2d_nopool": (1, 1, 1),
    "i3d": (2, 1, 1),
    "i3d_nopool": (1, 1, 1),
    "slow": (1, 1, 1),
    "slow_layer3": (1, 1, 1),
    "slow_layer4": (1, 1, 1),
    "slow_layer5": (1, 1, 1),
}

class _Conv(Conv3d):
    """A trunk conv: ``build_model`` keeps its weight channels-last."""

    channels_last = True


def _stage_conv(quant: bool, *args, **kwargs) -> nn.Module:
    """A bias-free stage conv, int8 (``QuantConv3d``) when ``quant``."""
    if quant:
        return QuantConv3d(*args, **kwargs)
    return _Conv(*args, bias=False, **kwargs)


def _bn(channels: int) -> BatchNorm3d:
    return BatchNorm3d(channels, eps=1e-5, momentum=0.1)


def _to_ncthw(x: torch.Tensor) -> torch.Tensor:
    """NTHWC -> the NCTHW view of it (channels_last_3d memory)."""
    return x.permute(0, 4, 1, 2, 3)


def _to_nthwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


class Nonlocal(nn.Module):
    """Non-local block on (B, C, T, H, W): theta, phi, g 1x1x1 convs (with
    bias) to ``dim_inner``, phi and g on the input max-pooled by
    ``pool_size`` (VALID), the affinity theta phi^T divided by its pooled
    position count (``dot_product``) or softmaxed in f32 at scale
    ``dim_inner ** -0.5`` (``softmax``), times g, ``conv_out`` back to C,
    the zero-init BN, and the residual."""

    def __init__(self, dim: int, dim_inner: int, pool_size=None,
                 instantiation: str = "dot_product"):
        super().__init__()
        if instantiation not in ("dot_product", "softmax"):
            raise NotImplementedError(
                f"Unknown nonlocal instantiation {instantiation}")
        self.dim_inner = dim_inner
        self.pool_size = (tuple(pool_size) if pool_size is not None
                          and any(s > 1 for s in pool_size) else None)
        self.instantiation = instantiation
        for name in ("conv_theta", "conv_phi", "conv_g"):
            setattr(self, name, _Conv(dim, dim_inner, 1))
        self.conv_out = _Conv(dim_inner, dim, 1)
        self.bn = _bn(dim)
        nn.init.zeros_(self.bn.weight)

    def forward(self, x):
        b, _, t, h, w = x.shape
        theta = _to_nthwc(self.conv_theta(x)).reshape(b, t * h * w, -1)
        xp = x if self.pool_size is None else F.max_pool3d(
            x, self.pool_size, self.pool_size)
        phi = _to_nthwc(self.conv_phi(xp)).reshape(b, -1, self.dim_inner)
        g = _to_nthwc(self.conv_g(xp)).reshape(b, -1, self.dim_inner)
        aff = torch.matmul(theta, phi.transpose(1, 2))
        if self.instantiation == "softmax":
            aff = torch.softmax(aff.float() * self.dim_inner ** -0.5,
                                dim=2).to(theta.dtype)
        else:   # in place: the affinity is the block's largest tensor
            aff = aff.div_(aff.shape[2])
        y = torch.matmul(aff, g).reshape(b, t, h, w, self.dim_inner)
        return x + self.bn(self.conv_out(_to_ncthw(y)))


def resolve_nonlocal(location, group=None, pool=None,
                     instantiation="dot_product", pathway=0):
    """The reference NONLOCAL.{LOCATION,GROUP,POOL,INSTANTIATION} lists ->
    the per-stage ``nonlocal_cfg`` tuple ``ResNet3D`` takes, or None when
    no stage enables a block. ``location`` is the reference per-stage x
    per-pathway nesting ([[[]], [[]], [[]], [[]]] by default)."""
    if location is None:
        return None
    sel = lambda stage: tuple(stage[pathway]) if stage and isinstance(
        stage[0], (list, tuple)) else tuple(stage)
    inds = tuple(sel(s) for s in location)
    if not any(inds):
        return None
    grp = tuple((s[pathway] if isinstance(s, (list, tuple)) else s)
                for s in (group or [1] * 4))
    pl = tuple(tuple(p) for p in (pool or [[1, 2, 2]] * 4))
    return (inds, grp, pl, instantiation)


class BottleneckTransform(nn.Module):
    """Tx1x1 -> 1x3x3 (the spatial stride) -> 1x1x1, BN after each, ReLU
    after the first two."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int,
                 temp_kernel: int, stride: int, dilation: int = 1,
                 quant: bool = False):
        super().__init__()
        t, d = temp_kernel, dilation
        self.a = _stage_conv(quant, dim_in, dim_inner, (t, 1, 1),
                             padding=(t // 2, 0, 0))
        self.a_bn = _bn(dim_inner)
        self.b = _stage_conv(quant, dim_inner, dim_inner, (1, 3, 3),
                             (1, stride, stride), padding=(0, d, d),
                             dilation=(1, d, d))
        self.b_bn = _bn(dim_inner)
        self.c = _stage_conv(quant, dim_inner, dim_out, 1)
        self.c_bn = _bn(dim_out)

    def forward(self, x):
        y = torch.relu(self.a_bn(self.a(x)))
        y = torch.relu(self.b_bn(self.b(y)))
        return self.c_bn(self.c(y))


class ResBlock(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dim_inner: int,
                 temp_kernel: int, stride: int, dilation: int = 1,
                 quant: bool = False):
        super().__init__()
        self.branch1 = self.branch1_bn = None
        if dim_in != dim_out or stride > 1:
            self.branch1 = _stage_conv(quant, dim_in, dim_out, 1,
                                       (1, stride, stride))
            self.branch1_bn = _bn(dim_out)
        self.branch2 = BottleneckTransform(dim_in, dim_out, dim_inner,
                                           temp_kernel, stride, dilation,
                                           quant)

    def forward(self, x):
        shortcut = x if self.branch1 is None else self.branch1_bn(
            self.branch1(x))
        return torch.relu(shortcut + self.branch2(x))


class ResStage(nn.Module):
    """``num_blocks`` ResBlocks (``block{i}``), a Nonlocal (``nonlocal{i}``)
    after each block index in ``nonlocal_inds``."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int,
                 num_blocks: int, temp_kernel_sizes: Sequence[int],
                 num_block_temp_kernel: int, stride: int, dilation: int = 1,
                 nonlocal_inds: Sequence[int] = (), nonlocal_group: int = 1,
                 nonlocal_pool: Any = None,
                 nonlocal_instantiation: str = "dot_product",
                 quant: bool = False):
        super().__init__()
        pattern = (list(temp_kernel_sizes)
                   * (num_blocks // len(temp_kernel_sizes) + 1))
        self.num_blocks = num_blocks
        self.nonlocal_inds = tuple(nonlocal_inds)
        self.nonlocal_group = nonlocal_group
        for i in range(num_blocks):
            tk = pattern[i] if i < num_block_temp_kernel else 1
            setattr(self, f"block{i}", ResBlock(
                dim_in if i == 0 else dim_out, dim_out, dim_inner, tk,
                stride if i == 0 else 1, dilation, quant))
            if i in self.nonlocal_inds:
                setattr(self, f"nonlocal{i}", Nonlocal(
                    dim_out, dim_out // 2, nonlocal_pool,
                    nonlocal_instantiation))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
            if i in self.nonlocal_inds:
                x = self._nonlocal(getattr(self, f"nonlocal{i}"), x)
        return x

    def _nonlocal(self, block, x):
        grp = self.nonlocal_group
        if grp == 1:
            return block(x)
        # T folded into the batch: clip i's frame chunk j is sample i grp + j
        b, c, t, h, w = x.shape
        y = _to_nthwc(x).reshape(b * grp, t // grp, h, w, c)
        y = _to_nthwc(block(_to_ncthw(y))).reshape(b, t, h, w, c)
        return _to_ncthw(y)


class VideoStem(nn.Module):
    """Conv (t, 7, 7) / (1, 2, 2) + BN + ReLU + max-pool (1, 3, 3) /
    (1, 2, 2) pad (0, 1, 1), on NTHWC frames -> NCTHW."""

    def __init__(self, dim_in: int, width: int, temp_kernel: int,
                 input_norm: Optional[Tuple[float, float]] = (0.45, 0.225),
                 dtype=torch.float32):
        super().__init__()
        t = temp_kernel
        self.conv = _Conv(dim_in, width, (t, 7, 7), (1, 2, 2),
                          padding=(t // 2, 3, 3), bias=False)
        self.bn = _bn(width)
        self.input_norm = input_norm
        self.compute_dtype = dtype

    def forward(self, x):
        if not x.is_floating_point() and self.input_norm is not None:
            mean, std = self.input_norm
            x = (x.float() / 255.0 - mean) / std
        y = torch.relu(self.bn(self.conv(_to_ncthw(x.to(self.compute_dtype)))))
        return F.max_pool3d(y, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class ResNet3D(ChecksCalibration, nn.Module):
    """Single-pathway trunk: (B, T, H, W, C) NTHWC frames ->
    (B, 32 width_per_group, T', H', W') NCTHW (channels_last_3d)."""

    def __init__(self, arch: str = "slow_layer5", depth: int = 50,
                 num_groups: int = 1, width_per_group: int = 64,
                 spatial_strides=(1, 2, 2, 2),
                 num_block_temp_kernel=(3, 4, 6, 3), remat: bool = False,
                 input_norm=(0.45, 0.225), nonlocal_cfg=None,
                 quant: bool = False, dtype=torch.float32):
        super().__init__()
        depths = MODEL_STAGE_DEPTH[depth]
        w = width_per_group
        dim_inner = num_groups * w
        tk = TEMPORAL_KERNEL_BASIS[arch]
        nl = nonlocal_cfg or (((),) * 4, (1,) * 4, (None,) * 4, "dot_product")
        self.pool1 = POOL1[arch][0]
        self.s1 = VideoStem(3, w, tk[0][0], input_norm, dtype)
        dims = (w, w * 4, w * 8, w * 16, w * 32)
        for i in range(4):
            setattr(self, f"s{i + 2}", ResStage(
                dims[i], dims[i + 1], dim_inner * 2 ** i, depths[i],
                tk[i + 1], num_block_temp_kernel[i], spatial_strides[i],
                nonlocal_inds=nl[0][i], nonlocal_group=nl[1][i],
                nonlocal_pool=nl[2][i], nonlocal_instantiation=nl[3],
                quant=quant))
        self.quant, self.calibrating = quant, False

    def forward(self, x):
        if self.quant and not self.calibrating:
            self.assert_calibrated_once()
        y = self.s1(x)
        for i in range(2, 6):
            y = getattr(self, f"s{i}")(y)
            if i == 2 and self.pool1 > 1:   # c2d / i3d temporal pool
                y = F.max_pool3d(y, (self.pool1, 1, 1), (self.pool1, 1, 1))
        return y


def trunk_edge(crop_size: int) -> int:
    """Edge of the res5 map at ``crop_size``: the stem conv and pool, then
    the three stride-2 stages, each (n - 1) // 2 + 1 (225 -> 8)."""
    for _ in range(5):
        crop_size = (crop_size - 1) // 2 + 1
    return crop_size


def head_tokens(channels: int, crop_size: int, spatial_pool: int) -> int:
    """Features of a frame's token after the head's (k, k) VALID pool:
    C (edge - k + 1)^2 (2048 x 2 x 2 = 8192 at crop 225, k 7)."""
    return channels * (trunk_edge(crop_size) - spatial_pool + 1) ** 2


class KeyframeLocalizationHead(nn.Module):
    """Per-frame head: AvgPool (temporal_pool, k, k) stride 1 VALID ->
    each frame's (C, H', W') flattened channel-major -> dropout ->
    ``projection`` -> ``act`` at eval. (B, C, T, H, W) -> (B, T', classes);
    ``middle=True`` returns the flattened per-frame tokens (B, T',
    C H' W'), of ``tokens`` features (``head_tokens``)."""

    def __init__(self, tokens: int, num_classes: int, spatial_pool: int,
                 dropout_rate: float = 0.0, act: str = "none"):
        super().__init__()
        self.spatial_pool = spatial_pool
        self.num_classes, self.act = num_classes, act
        self.dropout = Dropout(dropout_rate)
        self.projection = Linear(tokens, num_classes)

    def forward(self, x, middle: bool = False, temporal_pool: int = 1):
        """``temporal_pool``: the JAX head's field, given here since a full
        temporal pool's T' is known only from the input. The pool sums in
        f32 (the CPU has no bf16 avg_pool3d; CUDA's accumulates in f32
        too) and gives the input's dtype."""
        k = self.spatial_pool
        x = F.avg_pool3d(x.float(), (temporal_pool, k, k), 1).to(x.dtype)
        b, c, t = x.shape[:3]
        x = self.dropout(x.permute(0, 2, 1, 3, 4).reshape(b, t, -1))
        if middle:
            return x
        x = self.projection(x)
        if not self.training and self.act == "softmax":
            x = torch.softmax(x, dim=1 if self.num_classes == 1 else -1)
        return x


class ResNetBasicHead(nn.Module):
    """Global (T, H, W) mean -> dropout -> ``projection`` -> softmax at
    eval (``act="softmax"``)."""

    def __init__(self, dim_in: int, num_classes: int,
                 dropout_rate: float = 0.5, act: str = "softmax"):
        super().__init__()
        self.act = act
        self.dropout = Dropout(dropout_rate)
        self.projection = Linear(dim_in, num_classes)

    def forward(self, x):
        x = self.projection(self.dropout(x.mean((2, 3, 4))))
        if not self.training and self.act == "softmax":
            x = torch.softmax(x, dim=-1)
        return x

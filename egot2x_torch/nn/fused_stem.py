"""Fused RGB stem for the trunk pair that reads the same frames.

Counterpart of ``egot2x/nn/fused_stem.py``: under int8 inference the LAM
and TTM ResNet-18 stems run as one launch of ``stem_pool_q_2d`` with 128
output channels, LAM's 64 then TTM's, so the frames are read once. Each
half carries its own trunk's folded BN and its own ``stem_act_max`` step.
Parameters stay in the two trunks (checkpoints are unchanged); the fusion
reads them at call time and the trunks consume the halves via
``stem_in``.
"""

from __future__ import annotations

import torch

from egot2x_torch.ops.stem import fold_bn_quant, stem_pool_q_2d


def fused_rgb_stem(frames: torch.Tensor, trunks):
    """``frames`` (N, H, W, 3), normalized, in the compute dtype;
    ``trunks``: quant ``ResNet2D`` modules -> per trunk (int8 pooled map,
    an NCHW view (N, 64, H/4, W/4), its step), what ``stem_in`` takes."""
    folded = [fold_bn_quant(t.bn1, t.stem_act_max) for t in trunks]
    scale, bias, steps = (torch.cat(part) for part in zip(*folded))
    weight = torch.cat([t.conv1.weight for t in trunks])
    y = stem_pool_q_2d(frames.contiguous(), weight, scale, bias, steps)
    return [(y[..., 64 * i:64 * (i + 1)].permute(0, 3, 1, 2), steps[i])
            for i in range(len(trunks))]

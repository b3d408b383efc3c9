"""Fused RGB stem for the trunk pair that reads the same frames.

Counterpart of ``egot2x/nn/fused_stem.py``: under int8 inference the LAM
and TTM ResNet-18 stems run as one launch of ``stem_pool_q_2d`` with 128
output channels, LAM's 64 then TTM's, so the frames are read once. Each
half carries its own trunk's folded BN and its own ``stem_act_max`` step.
Parameters stay in the two trunks (checkpoints are unchanged); the fusion
stacks their weights once per loaded weight and the trunks consume the
halves via ``stem_in``.
"""

from __future__ import annotations

import torch

from egot2x_torch.ops.stem import fold_bn_quant, stem_pool_q_2d


_stacked = None    # (key, trunk weights, stacked weight)


def _stacked_weight(trunks):
    """The trunks' ``conv1`` weights stacked on the output channels. The
    same tensor comes back while the weights are unchanged (keyed on
    storage and version counter, holding the weights so that a key cannot
    come back for other tensors), so the stem wrapper's cache of the
    kernel's weights holds across calls."""
    global _stacked
    weights = [t.conv1.weight for t in trunks]
    key = tuple((w.data_ptr(), w._version, w.device) for w in weights)
    if _stacked is None or _stacked[0] != key:
        _stacked = (key, weights, torch.cat(weights).detach())
    return _stacked[2]


def fused_rgb_stem(frames: torch.Tensor, trunks):
    """``frames`` (N, H, W, 3), normalized, in the compute dtype;
    ``trunks``: quant ``ResNet2D`` modules -> per trunk (int8 pooled map,
    an NCHW view (N, 64, H/4, W/4), its step), what ``stem_in`` takes."""
    folded = [fold_bn_quant(t.bn1, t.stem_act_max) for t in trunks]
    scale, bias, steps = (torch.cat(part) for part in zip(*folded))
    y = stem_pool_q_2d(frames.contiguous(), _stacked_weight(trunks), scale,
                       bias, steps)
    return [(y[..., 64 * i:64 * (i + 1)].permute(0, 3, 1, 2), steps[i])
            for i in range(len(trunks))]

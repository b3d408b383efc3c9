"""Layers that compute in the dtype of their input.

How the port runs a compute dtype (``build_model(..., dtype=...)``): the
parameters stay f32, as flax keeps them, so ``state_dict`` and the weight
bridge do not change with the dtype. A model casts its inputs to the
compute dtype where it takes them (frames, MFCC, dequantized int8 maps);
from there each layer computes in the dtype of what it is given, and the
layers below cast their parameters to it at use. For f32 input every cast
is the identity, so the f32 path is torch's own. BatchNorm takes a bf16
input with f32 parameters and statistics as it is (statistics in f32,
output in the input's dtype), as flax's does; LayerNorm casts its
parameters, since CUDA's takes no mixed types.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


def _at(p, x):
    return None if p is None else p.to(x.dtype)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, _at(self.weight, x), _at(self.bias, x))


class Conv1d(nn.Conv1d):
    def forward(self, x):
        return self._conv_forward(x, _at(self.weight, x), _at(self.bias, x))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(x, _at(self.weight, x), _at(self.bias, x))


class PReLU(nn.PReLU):
    def forward(self, x):
        return F.prelu(x, _at(self.weight, x))


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, _at(self.weight, x),
                            _at(self.bias, x), self.eps)

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

BatchNorm in training mode has flax's semantics, which differ from
torch's in two ways (every JAX BN is ``flax.linen.BatchNorm(
use_running_average=not train, momentum=m, epsilon=e)``):

  * flax's ``momentum`` m weighs the running statistic, torch's the batch:
    a layer is built here with torch's ``momentum = 1 - m`` (0.1 for flax's
    0.9, 0.01 for TalkNet's AVSR 0.99);
  * flax updates ``running_var`` with the *biased* batch variance (it
    computes E[x^2] - E[x]^2), torch with the unbiased one (n / (n - 1)
    times it, a third larger at 4 values a channel).

So a training forward normalises with the batch mean and biased variance,
as both do, and updates ``running = m * running + (1 - m) * batch`` with
the biased variance. Eval mode is torch's own forward, untouched.
"""

from __future__ import annotations

import torch
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


class Conv3d(nn.Conv3d):
    def forward(self, x):
        return self._conv_forward(x, _at(self.weight, x), _at(self.bias, x))


class PReLU(nn.PReLU):
    def forward(self, x):
        return F.prelu(x, _at(self.weight, x))


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, _at(self.weight, x),
                            _at(self.bias, x), self.eps)


class _FlaxBatchNorm:
    """Training forward with flax's statistics (see the module note). The
    running update reads the batch statistics the normalisation saves
    (mean and 1 / sqrt(var + eps)), so the input is not read again."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = invstd.double().pow(-2) - self.eps
            self.running_mean.lerp_(mean.to(self.running_mean), self.momentum)
            self.running_var.lerp_(var.to(self.running_var), self.momentum)
            self.num_batches_tracked += 1
        return y


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    pass

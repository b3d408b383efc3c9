"""The Stage-I models' bidirectional LSTM.

Counterpart of ``egot2x/nn/lstm.py`` ``BiLSTM``: ``torch.nn.LSTM(256, 256,
num_layers=2, bidirectional=True, batch_first=True)`` as the reference
LAM and TTM models build it (cuDNN's LSTM on the card). The JAX package
computes it in ``lax.scan``, outside any Pallas kernel, in torch's gate
order [input, forget, cell, output] with ``W_ih x + b_ih + W_hh h + b_hh``
and torch's packed layout, stored transposed: the weight bridge takes its
``l{k}_fwd``/``l{k}_bwd`` ``w_ih`` (D, 4H) and ``w_hh`` (H, 4H) to
``weight_ih_l{k}[_reverse]`` (4H, D) and ``weight_hh_l{k}[_reverse]``
(4H, H), and keeps ``b_ih`` and ``b_hh`` apart.

``KeyframeCnnLSTM`` (HOI) runs one layer of 512 over its 512-d frame
features: ``BiLSTM(512, num_layers=1, input_size=512)``.

The LSTM computes in its parameters' type (f32) whatever the model's
compute dtype (its output is cast back), since cuDNN's takes no mixed
types.
"""

from __future__ import annotations

from torch import nn


class BiLSTM(nn.LSTM):
    """(B, T, input_size) -> (B, T, 2 hidden); ``input_size`` defaults to
    ``hidden``."""

    def __init__(self, hidden: int = 256, num_layers: int = 2,
                 input_size: int = None):
        super().__init__(input_size or hidden, hidden, num_layers=num_layers,
                         bidirectional=True, batch_first=True)

    def forward(self, x):
        out, _ = super().forward(x.to(self.weight_ih_l0.dtype))
        return out.to(x.dtype)

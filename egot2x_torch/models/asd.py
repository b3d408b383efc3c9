"""ASD (active speaker detection) models: TalkNet and its per-frame heads.

Counterpart of ``egot2x/models/asd.py``. ``talkNetModel`` is
the registered backbone; ``TalkNetWithHeads`` adds the reference's loss
modules' linear heads, ``lossAV.FC`` 256 -> 2 and ``lossA.FC`` /
``lossV.FC`` 128 -> 2, and returns their logits. Module names are the
reference's (``model`` for the backbone, ``lossAV.FC``, ``lossA.FC``,
``lossV.FC``), so its TalkNet checkpoints load as they are
(``strict=False``: they also hold the loss modules' criteria).

In training mode (Stage I, ``tasks/asd.py``) TalkNet's BNs normalise with
batch statistics and its attention layers drop out at rate 0.1, with the
masks drawn from the generator that ``nn/common.py::set_dropout_generator``
hands the model.

On a face track of ``FLASH_MIN_TOKENS`` (2048) frames or more, TalkNet's
three attention layers run through the flash kernel on the card
(``ops/attention.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from egot2x_torch.core.registry import MODEL_REGISTRY
from egot2x_torch.nn.layers import Linear
from egot2x_torch.nn.talknet import TalkNetModel


@MODEL_REGISTRY.register(name="talkNetModel")
class TalkNetBackbone(TalkNetModel):
    """The TalkNet backbone: (outsAV, outsA, outsV) per frame."""

    def __init__(self, dtype=torch.float32):
        super().__init__(dtype=dtype)


class LossHead(nn.Module):
    """A reference loss module's linear head: features -> 2 logits."""

    def __init__(self, in_features: int):
        super().__init__()
        self.FC = Linear(in_features, 2)

    def forward(self, x):
        return self.FC(x)


@MODEL_REGISTRY.register(name="TalkNetWithHeads")
class TalkNetWithHeads(nn.Module):
    """TalkNet + the three per-frame 2-class heads."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.model = TalkNetModel(dtype=dtype)
        self.lossAV = LossHead(256)
        self.lossA = LossHead(128)
        self.lossV = LossHead(128)

    def forward(self, mfcc, faces):
        """mfcc (B, 4T, 13), faces (B, T, H, W) grey in [0, 255] ->
        {"logits_av", "logits_a", "logits_v"}, each (B, T, 2) in the
        compute dtype."""
        outs_av, outs_a, outs_v = self.model(mfcc, faces)
        return {"logits_av": self.lossAV(outs_av),
                "logits_a": self.lossA(outs_a),
                "logits_v": self.lossV(outs_v)}

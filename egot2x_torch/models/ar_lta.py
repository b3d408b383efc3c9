"""AR (action recognition) Stage-I models: inference on the card.

Counterpart of ``egot2x/models/ar_lta.py``, its SlowFast models only:

  * ``MultiTaskSlowFast``: the SlowFast trunk (``trunk``) and a verb + noun
    ``MultiTaskHead`` (``head``) -> [(B, 115), (B, 478)] logits from one
    clip at the AR task's build (``egot2x/tasks/ar.py``: depth 50, alpha
    8, beta_inv 8); ``middle=True`` returns the two res5 maps.
  * ``SlowFastFeature``: the same trunk with a one-output head of
    ``feature_dim`` -> (B, feature_dim), the clip backbone of the LTA
    models.

As in the JAX package, ``MultiTaskSlowFast`` passes ``depth`` but not
``num_block_temp_kernel``: at depth 101 res4 keeps the default 6 blocks
with a temporal kernel, not the reference config's 23. Inputs are
``[slow (B, T / alpha, H, W, 3), fast (B, T, H, W, 3)]`` NTHWC frames,
uint8 (normalised in the stems) or float (taken as they are). The AR/LTA
aggregators and decoder are not ported yet. Neither model takes ``quant``:
the JAX classes have no such field, so their trunks run float.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from egot2x_torch.core.registry import MODEL_REGISTRY
from egot2x_torch.nn.slowfast import MultiTaskHead, SlowFast


def head_dim(beta_inv: int) -> int:
    """Channels of the two res5 maps the head concatenates (2048 + 256)."""
    return 2048 + 2048 // beta_inv


@MODEL_REGISTRY.register(name="MultiTaskSlowFast")
class MultiTaskSlowFast(nn.Module):
    def __init__(self, num_classes: Sequence[int] = (115, 478),
                 alpha: int = 8, beta_inv: int = 8, depth: int = 50,
                 dtype=torch.float32):
        super().__init__()
        self.trunk = SlowFast(depth=depth, alpha=alpha, beta_inv=beta_inv,
                              dtype=dtype)
        self.head = MultiTaskHead(head_dim(beta_inv), num_classes)

    def forward(self, pathways, middle: bool = False):
        feats = self.trunk(pathways)
        return feats if middle else self.head(feats)


@MODEL_REGISTRY.register(name="SlowFastFeature")
class SlowFastFeature(nn.Module):
    def __init__(self, feature_dim: int = 2048, alpha: int = 8,
                 beta_inv: int = 8, dtype=torch.float32):
        super().__init__()
        self.trunk = SlowFast(alpha=alpha, beta_inv=beta_inv, dtype=dtype)
        self.head = MultiTaskHead(head_dim(beta_inv), (feature_dim,))

    def forward(self, pathways, middle: bool = False):
        feats = self.trunk(pathways)
        return feats if middle else self.head(feats)[0]

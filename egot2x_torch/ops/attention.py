"""Multi-head scaled dot-product attention in the (B, T, H, Dh) layout.

Counterpart of the XLA branch of ``egot2x/ops/attention.py``. The
translator's sequences hold at most a few hundred tokens, so this is plain
tensor code; the TPU flash kernel that the JAX package routes sequences of
2048 tokens or more to is ported with MViT, its only caller.
"""

from __future__ import annotations

import math

import torch


def dot_product_attention(q, k, v):
    """q (B, T, H, Dh), k and v (B, S, H, Dh) -> (B, T, H, Dh).

    Logits and softmax run in f32 whatever the input dtype, as in the JAX
    package; no mask (the translators attend over every token)."""
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    probs = torch.softmax(logits / math.sqrt(q.shape[-1]), dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)

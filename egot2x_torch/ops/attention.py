"""Multi-head scaled dot-product attention in the (B, T, H, Dh) layout.

Counterpart of ``egot2x/ops/attention.py``, with its route: on the card,
unmasked attention whose queries and keys both hold ``FLASH_MIN_TOKENS``
or more goes to the flash kernel (``ops/flash.py``), which reads this
layout in place, at any head dim; everything else, and every CPU tensor,
is plain tensor code. The kernel has no backward, and its wrapper raises
on inputs that autograd would differentiate. TalkNet's three attention
layers reach the kernel on a face track of 2048 frames or more; the
translators' sequences (a few hundred tokens) and MViT (its own pooled
attention) never do.
"""

from __future__ import annotations

import math

import torch

from egot2x_torch.ops import flash

FLASH_MIN_TOKENS = 2048


def routes_to_flash(device: torch.device, t: int, s: int) -> bool:
    """Whether attention of ``t`` queries over ``s`` keys on ``device``
    takes the flash kernel."""
    return (device.type == "cuda" and t >= FLASH_MIN_TOKENS
            and s >= FLASH_MIN_TOKENS)


def dot_product_attention(q, k, v, probs_dropout=None):
    """q (B, T, H, Dh), k and v (B, S, H, Dh) -> (B, T, H, Dh).

    Logits and softmax run in f32 whatever the input dtype, as in the JAX
    package; no mask (the port's attention layers attend over every
    token). ``probs_dropout``, a callable on the probabilities, takes the
    explicit path, as the JAX package's attention dropout does."""
    if probs_dropout is None and routes_to_flash(q.device, q.shape[1],
                                                 k.shape[1]):
        return flash.flash_attention(q, k, v)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    probs = torch.softmax(logits / math.sqrt(q.shape[-1]), dim=-1)
    if probs_dropout is not None:
        probs = probs_dropout(probs)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)

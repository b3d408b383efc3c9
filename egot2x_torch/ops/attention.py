"""Multi-head scaled dot-product attention in the (B, T, H, Dh) layout.

Counterpart of ``egot2x/ops/attention.py``, with its route: on the card,
unmasked, non-causal attention whose queries and keys both hold
``FLASH_MIN_TOKENS`` or more goes to the flash kernel (``ops/flash.py``),
which reads this layout in place, at any head dim; everything else, and
every CPU tensor, is plain tensor code. Masked or causal attention never
launches the kernel, as in the JAX package. The kernel has no backward,
and its wrapper raises on inputs that autograd would differentiate.
TalkNet's three attention layers reach the kernel on a face track of 2048
frames or more, and the EgoT2-g prompt encoder on an ASD track of 683
frames or more (three streams of T tokens); the other translators'
sequences (a few hundred tokens), the prompt decoder (causal) and MViT
(its own pooled attention) never do.
"""

from __future__ import annotations

import math

import torch

from egot2x_torch.ops import flash

FLASH_MIN_TOKENS = 2048


def routes_to_flash(device: torch.device, t: int, s: int) -> bool:
    """Whether unmasked, non-causal attention of ``t`` queries over ``s``
    keys on ``device`` takes the flash kernel."""
    return (device.type == "cuda" and t >= FLASH_MIN_TOKENS
            and s >= FLASH_MIN_TOKENS)


def attention_logits(q, k, mask=None, is_causal=False):
    """(B, H, T, S) f32 logits q k^T / sqrt(Dh), -inf where ``mask``
    (True to keep, broadcast to (B, 1|H, T, S)) or the causal mask
    (``tril(ones(T, S))``, aligned top-left also when T != S) drops a
    key."""
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    logits = logits / math.sqrt(q.shape[-1])
    if is_causal:
        t, s = logits.shape[-2:]
        causal = torch.ones(t, s, dtype=torch.bool,
                            device=logits.device).tril()
        logits = logits.masked_fill(~causal, -math.inf)
    if mask is not None:
        logits = logits.masked_fill(~mask, -math.inf)
    return logits


def dot_product_attention(q, k, v, mask=None, is_causal=False,
                          probs_dropout=None):
    """q (B, T, H, Dh), k and v (B, S, H, Dh) -> (B, T, H, Dh).

    Logits and softmax run in f32 whatever the input dtype, as in the JAX
    package. ``mask`` is True to keep and broadcasts to (B, 1|H, T, S);
    ``is_causal`` keeps key j for query i where j <= i. Rows that the mask
    drops whole come out as zeros, as the JAX package's ``nan_to_num``
    makes them. ``probs_dropout``, a callable on the probabilities, takes
    the explicit path of the JAX package's attention dropout, which does
    not zero such rows."""
    if (probs_dropout is None and mask is None and not is_causal
            and routes_to_flash(q.device, q.shape[1], k.shape[1])):
        return flash.flash_attention(q, k, v)
    probs = torch.softmax(attention_logits(q, k, mask, is_causal), dim=-1)
    if probs_dropout is not None:
        probs = probs_dropout(probs)
    elif mask is not None:
        probs = torch.nan_to_num(probs)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)

"""Transformer building blocks: sinusoidal PE, MHA, the post-LN encoder
and the post-LN decoder.

Counterpart of ``egot2x/nn/common.py``. Modules are batch-major
(B, T, D). Parameter names follow ``torch.nn.MultiheadAttention`` /
``TransformerEncoderLayer`` / ``TransformerDecoderLayer`` (packed
``in_proj_weight``), so reference checkpoints load as they are; the JAX
package's separate q/k/v Dense layers are concatenated by the weight
bridge (``egot2x_torch.core.bridge``).

LayerNorm epsilon is 1e-6 everywhere, the Flax default the JAX package
runs with, not torch's 1e-5. Layers compute in the dtype of their input
(``egot2x_torch.nn.layers``).

Dropout sits where the JAX package's does: after the PE, on the attention
probabilities, after each attention and twice in the FFN. It acts in train
mode only, so eval mode is the inference path, and its masks come from
the ``torch.Generator`` that :func:`set_dropout_generator` hands every
:class:`Dropout` of a model, never from the global RNG.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from egot2x_torch.nn.layers import LayerNorm, Linear
from egot2x_torch.ops.attention import attention_logits, dot_product_attention

LN_EPS = 1e-6


def layer_norm(d_model: int) -> nn.LayerNorm:
    return LayerNorm(d_model, eps=LN_EPS)


class Dropout(nn.Module):
    """flax's ``nn.Dropout`` in train mode: keep each element with
    probability 1 - p, scaled by 1 / (1 - p); the identity in eval mode
    or at p = 0. The mask is drawn from ``self.generator``, which must be
    on the input's device."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("dropout in train mode needs a generator: "
                               "call set_dropout_generator(model, g)")
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def set_dropout_generator(model: nn.Module, generator: torch.Generator):
    """Draw the masks of every :class:`Dropout` in ``model`` from
    ``generator``. Returns ``model``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    return model


def sinusoidal_positional_encoding(max_len: int, d_model: int) -> torch.Tensor:
    """Classic transformer PE table (max_len, d_model), f32."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                         * (-math.log(10000.0) / d_model))
    pe = torch.zeros(max_len, d_model)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term[: d_model // 2])
    return pe


class PositionalEncoding(nn.Module):
    """Add sinusoidal PE over the time axis of (B, T, D), then dropout."""

    def __init__(self, d_model: int, max_len: int = 5000,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = Dropout(dropout)
        # not persistent: the table is a function of the shape, and the
        # reference checkpoints' ``pos_embed.pe`` buffer carries nothing
        self.register_buffer(
            "pe", sinusoidal_positional_encoding(max_len, d_model),
            persistent=False)

    def forward(self, x):
        return self.dropout(x + self.pe[: x.shape[1]].to(x.dtype))


class MultiHeadAttention(nn.Module):
    """MHA with ``torch.nn.MultiheadAttention``'s parameters (bias=True);
    ``dropout`` drops attention probabilities in train mode."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by {num_heads}")
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.dropout = Dropout(dropout)

    def forward(self, query, key, value, mask=None, is_causal=False,
                return_weights=False):
        """query (B, T, D), key and value (B, S, D) -> (B, T, D); ``mask``
        (True to keep, broadcast to (B, 1|H, T, S)) and ``is_causal`` as
        in ``ops/attention.py``. ``return_weights`` also returns the
        attention probabilities averaged over the heads, (B, T, S), without
        dropout."""
        w_q, w_k, w_v = self.in_proj_weight.to(query.dtype).chunk(3)
        b_q, b_k, b_v = self.in_proj_bias.to(query.dtype).chunk(3)
        b, t, d = query.shape
        heads = lambda x: x.reshape(x.shape[0], x.shape[1], self.num_heads, -1)
        q = heads(F.linear(query, w_q, b_q))
        k = heads(F.linear(key, w_k, b_k))
        v = heads(F.linear(value, w_v, b_v))
        drop = self.dropout
        probs_dropout = drop if drop.training and drop.p > 0.0 else None
        out = self.out_proj(dot_product_attention(
            q, k, v, mask, is_causal, probs_dropout).reshape(b, t, d))
        if not return_weights:
            return out
        logits = attention_logits(q, k, mask, is_causal)
        return out, torch.softmax(logits, dim=-1).mean(dim=1)


class TransformerEncoderLayer(nn.Module):
    """Post-LN layer (torch ``nn.TransformerEncoderLayer`` default layout):
    x = norm1(x + dropout1(attn(x)));
    x = norm2(x + dropout2(linear2(dropout(relu(linear1(x)))))).

    ``dtype``, where given, is the compute dtype of the attention and of
    ``norm1``'s output, for input that comes wider: flax's layers cast
    what they take to their dtype, so an f32 input under bf16 layers is
    attended in bf16, added to the bf16 attention in f32 and normalised to
    bf16 (the HOI translators' f32 sum of a bf16 LayerNorm and an f32
    PE). None computes in the input's dtype."""

    def __init__(self, d_model: int, num_heads: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 dtype=None):
        super().__init__()
        self.compute_dtype = dtype
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.dropout, self.dropout1, self.dropout2 = (
            Dropout(dropout) for _ in range(3))

    def forward(self, x, mask=None):
        h = x if self.compute_dtype is None else x.to(self.compute_dtype)
        x = self.norm1(x + self.dropout1(self.self_attn(h, h, h, mask)))
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        h = self.dropout(torch.relu(self.linear1(x)))
        return self.norm2(x + self.dropout2(self.linear2(h)))


class TransformerEncoder(nn.Module):
    """Stack of post-LN encoder layers (``layers.{i}``); ``dtype`` as the
    layer's."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, num_heads, dim_feedforward,
                                    dropout, dtype)
            for _ in range(num_layers))

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class TransformerDecoderLayer(nn.Module):
    """Post-LN decoder layer (torch ``nn.TransformerDecoderLayer`` default
    layout, the reference's ``CustomDecoderLayer``):
    x = norm1(x + dropout1(self_attn(x), causal by default));
    x = norm2(x + dropout2(multihead_attn(x, memory)));
    x = norm3(x + dropout3(linear2(dropout(relu(linear1(x))))))."""

    def __init__(self, d_model: int, num_heads: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout)
        self.multihead_attn = MultiHeadAttention(d_model, num_heads, dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1, self.norm2, self.norm3 = (
            layer_norm(d_model) for _ in range(3))
        self.dropout, self.dropout1, self.dropout2, self.dropout3 = (
            Dropout(dropout) for _ in range(4))

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                is_causal=True, return_weights=False):
        """tgt (B, T, D), memory (B, S, D) -> (B, T, D), and with
        ``return_weights`` the cross-attention's head-mean probabilities
        (B, T, S)."""
        sa = self.self_attn(tgt, tgt, tgt, tgt_mask, is_causal)
        x = self.norm1(tgt + self.dropout1(sa))
        ca = self.multihead_attn(x, memory, memory, memory_mask,
                                 return_weights=return_weights)
        ca, weights = ca if return_weights else (ca, None)
        x = self.norm2(x + self.dropout2(ca))
        h = self.dropout(torch.relu(self.linear1(x)))
        x = self.norm3(x + self.dropout3(self.linear2(h)))
        return (x, weights) if return_weights else x


class TransformerDecoder(nn.Module):
    """Stack of post-LN decoder layers (``layers.{i}``); with
    ``return_weights`` the last layer's cross-attention weights too."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 dim_feedforward: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, num_heads, dim_feedforward,
                                    dropout)
            for _ in range(num_layers))

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                is_causal=True, return_weights=False):
        x, weights = tgt, None
        for layer in self.layers:
            x = layer(x, memory, tgt_mask, memory_mask, is_causal,
                      return_weights)
            if return_weights:
                x, weights = x
        return (x, weights) if return_weights else x

"""Transformer building blocks: sinusoidal PE, MHA, the post-LN encoder.

Counterpart of ``egot2x/nn/common.py``, inference only (no dropout).
Modules are batch-major (B, T, D). Parameter names follow
``torch.nn.MultiheadAttention`` / ``TransformerEncoderLayer`` (packed
``in_proj_weight``), so reference checkpoints load as they are; the JAX
package's separate q/k/v Dense layers are concatenated by the weight
bridge (``egot2x_torch.core.bridge``).

LayerNorm epsilon is 1e-6 everywhere, the Flax default the JAX package
runs with, not torch's 1e-5.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from egot2x_torch.ops.attention import dot_product_attention

LN_EPS = 1e-6


def layer_norm(d_model: int) -> nn.LayerNorm:
    return nn.LayerNorm(d_model, eps=LN_EPS)


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
    """Add sinusoidal PE over the time axis of (B, T, D)."""

    def __init__(self, d_model: int, max_len: int = 5000):
        super().__init__()
        # not persistent: the table is a function of the shape, and the
        # reference checkpoints' ``pos_embed.pe`` buffer carries nothing
        self.register_buffer(
            "pe", sinusoidal_positional_encoding(max_len, d_model),
            persistent=False)

    def forward(self, x):
        return x + self.pe[: x.shape[1]].to(x.dtype)


class MultiHeadAttention(nn.Module):
    """MHA with ``torch.nn.MultiheadAttention``'s parameters (bias=True)."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by {num_heads}")
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query, key, value):
        """query (B, T, D), key and value (B, S, D) -> (B, T, D)."""
        w_q, w_k, w_v = self.in_proj_weight.chunk(3)
        b_q, b_k, b_v = self.in_proj_bias.chunk(3)
        b, t, d = query.shape
        heads = lambda x: x.reshape(x.shape[0], x.shape[1], self.num_heads, -1)
        q = heads(F.linear(query, w_q, b_q))
        k = heads(F.linear(key, w_k, b_k))
        v = heads(F.linear(value, w_v, b_v))
        return self.out_proj(dot_product_attention(q, k, v).reshape(b, t, d))


class TransformerEncoderLayer(nn.Module):
    """Post-LN layer (torch ``nn.TransformerEncoderLayer`` default layout):
    x = norm1(x + attn(x)); x = norm2(x + linear2(relu(linear1(x))))."""

    def __init__(self, d_model: int, num_heads: int,
                 dim_feedforward: int = 2048):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, num_heads)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x, x, x))
        return self.norm2(x + self.linear2(torch.relu(self.linear1(x))))


class TransformerEncoder(nn.Module):
    """Stack of post-LN encoder layers (``layers.{i}``)."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 dim_feedforward: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, num_heads, dim_feedforward)
            for _ in range(num_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

"""Pre-LN ViT encoder ("simple_vit").

Counterpart of ``egot2x/nn/simple_vit.py``'s encoder, which the PNR-side
``TaskFusionMFTransformer3TaskPnr`` translator runs: per layer ``x =
attn_i(x) + x; x = ff_i(x) + x``, where ``SimpleViTAttention`` LayerNorms
its input, projects it with a fused bias-free ``to_qkv``, attends (logits
times ``dim_head ** -0.5``, softmax) and projects back with a bias-free
``to_out``, and ``SimpleViTFeedForward`` is LayerNorm, ``fc1``, exact
(erf) GELU, ``fc2``. LayerNorm eps is flax's 1e-6.

``dtype`` is the compute dtype: each block casts its LayerNorm's output to
it, as flax's ``LayerNorm(dtype=...)`` emits it, and computes its
projections and attention in it (the JAX package's einsum and softmax run
in that dtype too). The residual stream keeps the dtype it comes in: an f32
stream stays f32 under bf16 blocks, as jnp promotes ``bf16 + f32``. The
sequences are a few dozen tokens, so attention is plain tensor code. The
patch-embedding ``SimpleViT`` classifier is not ported: no model of the
port uses it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from egot2x_torch.nn.common import layer_norm
from egot2x_torch.nn.layers import Linear


class SimpleViTAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head, self.compute_dtype = heads, dim_head, dtype
        inner = heads * dim_head
        self.norm = layer_norm(dim)
        self.to_qkv = Linear(dim, inner * 3, bias=False)
        self.to_out = Linear(inner, dim, bias=False)

    def forward(self, x):
        b, n, _ = x.shape
        qkv = self.to_qkv(self.norm(x).to(self.compute_dtype))
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head)
                   for t in qkv.chunk(3, dim=-1))
        dots = torch.einsum("bihd,bjhd->bhij", q, k) * self.dim_head ** -0.5
        out = torch.einsum("bhij,bjhd->bihd", torch.softmax(dots, dim=-1), v)
        return self.to_out(out.reshape(b, n, -1))


class SimpleViTFeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.norm = layer_norm(dim)
        self.fc1 = Linear(dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, dim)

    def forward(self, x):
        y = self.fc1(self.norm(x).to(self.compute_dtype))
        return self.fc2(F.gelu(y, approximate="none"))


class SimpleViTEncoder(nn.Module):
    """``depth`` pre-LN attention and feed-forward residual blocks
    (``attn_{i}``, ``ff_{i}``)."""

    def __init__(self, dim: int, depth: int = 3, heads: int = 8,
                 dim_head: int = 64, mlp_dim: int = 512,
                 dtype=torch.float32):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"attn_{i}",
                    SimpleViTAttention(dim, heads, dim_head, dtype))
            setattr(self, f"ff_{i}",
                    SimpleViTFeedForward(dim, mlp_dim, dtype))

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"attn_{i}")(x) + x
            x = getattr(self, f"ff_{i}")(x) + x
        return x

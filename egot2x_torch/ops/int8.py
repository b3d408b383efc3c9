"""int8 primitives of the static-PTQ path: quantize, pool, convolve.

Counterparts of ``egot2x/nn/quant.py``'s ``quantize_static`` (:160) and
``max_pool_int8`` (:169), and of the int8 convolutions inside its
``QuantConv`` (:102) and ``QuantConv3D`` (:154)
(``jax.lax.conv_general_dilated(..., preferred_element_type=int32)``).
Those convolutions are XLA ops, not TPU kernels, and stock PyTorch has no
CUDA int8 convolution, so ``conv2d_int8`` and ``conv3d_int8`` compute them
as a library product: an int8 im2col (pad + ``Tensor.unfold``, channels
last) and ``torch._int_mm`` (int8 x int8 -> int32, exact); a 1x1(x1) conv
needs no im2col. Their plain versions, which CPU tensors take and the card
checks them against, are float64 convolutions of the int8 values: exact
too, since |acc| <= 4608 * 127^2 (2D) and 3 * 2048 * 127^2 (3D, the HOI
trunks' widest K) < 2^53, where f32 (2^24) would not be.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def act_scale(act_max: torch.Tensor) -> torch.Tensor:
    """The int8 step of a calibrated max-abs: max(act_max, 1e-6) / 127."""
    return torch.clamp(act_max.float(), min=1e-6) / 127.0


def quantize_static(x: torch.Tensor, act_max: torch.Tensor):
    """Symmetric per-tensor int8 with a calibrated max-abs -> (int8, scale).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    s = act_scale(act_max)
    q = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    return q, s


def max_pool_int8(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 pad-1 max-pool of (N, H, W, C) int8, padding with -128."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=-128)
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    windows = [xp[:, i:i + 2 * ho - 1:2, j:j + 2 * wo - 1:2]
               for i in range(3) for j in range(3)]
    return torch.stack(windows).amax(dim=0)


def conv2d_int8_plain(xq, wq, stride: int, padding: int) -> torch.Tensor:
    """Exact int32 accumulator of the int8 conv (float64 arithmetic).
    xq (N, C, H, W) int8, wq (O, C, kh, kw) int8 -> (N, O, Ho, Wo) int32."""
    acc = F.conv2d(xq.double(), wq.double(), stride=stride, padding=padding)
    return acc.to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _int_mm(a, b_t):
    """``torch._int_mm(a, b_t.t())`` with zero padding where a shape breaks
    its rules (rows > 16; inner and output widths multiples of 8): zeros
    add nothing to an integer sum, so the result is exact."""
    m, k = a.shape
    n = b_t.shape[0]
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b_t = F.pad(b_t, (0, kp - k, 0, np_ - n))
    return torch._int_mm(a, b_t.t())[:m, :n]


def im2col_int_mm(xq, wq, stride: int, padding: int) -> torch.Tensor:
    """The int8 conv as an NHWC im2col and one ``torch._int_mm``, on the
    tensors' own device: what ``conv2d_int8`` runs on a CUDA tensor."""
    n, c = xq.shape[:2]
    o, ci, kh, kw = wq.shape
    if ci != c:
        raise ValueError(f"weight takes {ci} channels, input has {c}")
    x = F.pad(xq.permute(0, 2, 3, 1), (0, 0, padding, padding, padding,
                                       padding))
    cols = x.unfold(1, kh, stride).unfold(2, kw, stride)  # N,Ho,Wo,C,kh,kw
    ho, wo = cols.shape[1], cols.shape[2]
    acc = _int_mm(cols.reshape(n * ho * wo, c * kh * kw),
                  wq.reshape(o, c * kh * kw))
    return acc.view(n, ho, wo, o).permute(0, 3, 1, 2)


def conv2d_int8(xq, wq, stride: int, padding: int) -> torch.Tensor:
    """int8 conv with an exact int32 accumulator. xq (N, C, H, W) int8, any
    strides (the port keeps maps channels_last), wq (O, C, kh, kw) int8 ->
    (N, O, Ho, Wo) int32. A CPU tensor takes the plain version; a CUDA
    tensor goes through ``im2col_int_mm`` and counts one launch in
    ``conv2d_int8.launches``."""
    if xq.device.type == "cpu":
        return conv2d_int8_plain(xq, wq, stride, padding)
    if xq.device.type != "cuda":
        raise ValueError(f"int8 conv runs on CUDA tensors, not {xq.device}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8 conv takes int8, not {xq.dtype}/{wq.dtype}")
    acc = im2col_int_mm(xq, wq, stride, padding)
    conv2d_int8.launches += 1
    return acc


conv2d_int8.launches = 0


def _triple(v):
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def conv3d_int8_plain(xq, wq, stride, padding) -> torch.Tensor:
    """Exact int32 accumulator of the int8 3D conv (float64 arithmetic).
    xq (N, C, T, H, W) int8, wq (O, C, kt, kh, kw) int8 -> (N, O, To, Ho,
    Wo) int32; ``stride`` and ``padding`` an int or a (t, h, w) triple."""
    acc = F.conv3d(xq.double(), wq.double(), stride=_triple(stride),
                   padding=_triple(padding))
    return acc.to(torch.int32)


def im2col_int_mm_3d(xq, wq, stride, padding) -> torch.Tensor:
    """The int8 3D conv as an NTHWC im2col and one ``torch._int_mm``, on the
    tensors' own device: what ``conv3d_int8`` runs on a CUDA tensor. The
    columns' K order is (C, kt, kh, kw), ``wq.reshape(O, -1)``'s. A 1x1x1
    kernel takes the NTHWC map itself (strided first where the stride is
    not 1) as the (rows, C) operand. Returns NCTHW, channels_last_3d."""
    n, c = xq.shape[:2]
    o, ci, kt, kh, kw = wq.shape
    if ci != c:
        raise ValueError(f"weight takes {ci} channels, input has {c}")
    (st, sh, sw), (pt, ph, pw) = _triple(stride), _triple(padding)
    x = xq.permute(0, 2, 3, 4, 1)   # NTHWC (a view of channels_last_3d)
    if (kt, kh, kw) == (1, 1, 1) and (pt, ph, pw) == (0, 0, 0):
        cols = x[:, ::st, ::sh, ::sw]
    else:
        x = F.pad(x, (0, 0, pw, pw, ph, ph, pt, pt))
        cols = (x.unfold(1, kt, st).unfold(2, kh, sh).unfold(3, kw, sw))
    to, ho, wo = cols.shape[1:4]   # cols: N, To, Ho, Wo, C[, kt, kh, kw]
    acc = _int_mm(cols.reshape(n * to * ho * wo, c * kt * kh * kw),
                  wq.reshape(o, c * kt * kh * kw))
    return acc.view(n, to, ho, wo, o).permute(0, 4, 1, 2, 3)


def conv3d_int8(xq, wq, stride, padding) -> torch.Tensor:
    """int8 3D conv with an exact int32 accumulator. xq (N, C, T, H, W)
    int8 (the port keeps maps channels_last_3d), wq (O, C, kt, kh, kw) int8,
    dilation 1 -> (N, O, To, Ho, Wo) int32. A CPU tensor takes the plain
    version; a CUDA tensor goes through ``im2col_int_mm_3d`` and counts one
    launch in ``conv3d_int8.launches``."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8 conv takes int8, not {xq.dtype}/{wq.dtype}")
    if xq.device.type == "cpu":
        return conv3d_int8_plain(xq, wq, stride, padding)
    if xq.device.type != "cuda":
        raise ValueError(f"int8 conv runs on CUDA tensors, not {xq.device}")
    acc = im2col_int_mm_3d(xq, wq, stride, padding)
    conv3d_int8.launches += 1
    return acc


conv3d_int8.launches = 0

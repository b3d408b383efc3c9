"""Fused stems: stride-2 conv + folded eval-BN + ReLU + 3x3/2 max-pool.

Counterparts of the two TPU stem kernels of ``egot2x/ops/pallas_stem.py``
that the frame trunks and TalkNet run their stems through. On a CUDA
tensor each wrapper launches a hand-written Hopper kernel of
``csrc/stem_pool.cu``; on a CPU tensor it runs the plain PyTorch version
beside it (``*_plain``), which the tests hold against the JAX package and
the card holds the kernel against.

Float (``fused_stem_pool``):

* ``stem_pool_2d``: ResNet-18 ``conv1`` 7x7/2 pad 3 on (N, H, W, 3) NHWC
  frames -> (N, H/4, W/4, 64) NHWC.
* ``stem_pool_3d``: TalkNet ``frontend3D`` 5x7x7 stride (1, 2, 2) on
  (B, T, H, W) grey clips, temporal zero-pad 2 per sample ->
  (B*T, H/4, W/4, 64) NHWC.

int8 (``fused_stem_pool_q``), for the static-PTQ path: the same conv, BN
and ReLU, then ``quantize_static`` with each trunk's step ``s`` and an
int8 max-pool (quantizing before the pool is exact: max commutes with the
monotonic quantizer), so only the pooled int8 map is written.

* ``stem_pool_q_2d``: n = 1 or 2 trunks stacked on the output channels in
  one launch that reads the frames once (the fused LAM + TTM stem) ->
  (N, H/4, W/4, 64 n) int8.
* ``stem_pool_q_3d``: the TalkNet stem -> (B*T, H/4, W/4, 64) int8.

What bounds the kernels on an H100, and what their design does about it,
is in the kernel's source note. In short: they are compute-bound (1.12
TFLOP per 2D trunk at 4800 frames of 224^2, ~16.7 ms at the 67 TFLOP/s of
the f32 CUDA cores), so they keep the pre-pool conv map in shared memory
and spend their device-memory traffic on the input once and the pooled
output once.

Each wrapper counts its kernel launches in ``.launches`` (CPU calls do not
count), so a run can show that its stems went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from egot2x_torch.ops import build
from egot2x_torch.ops.int8 import act_scale, max_pool_int8

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fold_bn(gamma, beta, mean, var, eps: float):
    """Eval-mode BN as ``y = x * scale + bias`` -> (scale, bias), f32."""
    scale = gamma.float() / torch.sqrt(var.float() + eps)
    return scale, beta.float() - mean.float() * scale


def fold_bn_quant(bn, act_max):
    """An eval BatchNorm module and a calibrated max-abs as the int8 stem's
    (scale, bias, s). Where ``egot2x``'s ``fold_bn_quant`` folds 1/s into
    scale and bias, the kernels keep the divide by s, as the XLA int8 stems
    that ship in ``egot2x`` do."""
    scale, bias = fold_bn(bn.weight, bn.bias, bn.running_mean,
                          bn.running_var, bn.eps)
    return scale, bias, act_scale(act_max).reshape(1)


def pooled_size(n: int) -> int:
    """Edge of the pooled map: conv 7/2 pad 3, then pool 3/2 pad 1."""
    conv = (n - 1) // 2 + 1
    return (conv - 1) // 2 + 1


def _pool_affine_relu(y, scale, bias):
    y = torch.relu(y * scale[:, None, None] + bias[:, None, None])
    return F.max_pool2d(y, 3, 2, 1).permute(0, 2, 3, 1)


def stem_pool_2d_plain(x, weight, scale, bias):
    """(N, H, W, C) NHWC, weight (64, C, 7, 7) -> (N, H/4, W/4, 64) NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), stride=2,
                 padding=3)
    return _pool_affine_relu(y, scale.to(y.dtype), bias.to(y.dtype))


def stem_pool_3d_plain(x, weight, scale, bias):
    """(B, T, H, W), weight (64, 1, 5, 7, 7) -> (B*T, H/4, W/4, 64) NHWC.
    The conv runs over each clip on its own, so the temporal zero-pad is
    per sample."""
    y = F.conv3d(x.unsqueeze(1), weight.to(x.dtype), stride=(1, 2, 2),
                 padding=(2, 3, 3))                      # (B, 64, T, Hc, Wc)
    y = y.transpose(1, 2).flatten(0, 1)                 # (B*T, 64, Hc, Wc)
    return _pool_affine_relu(y, scale.to(y.dtype), bias.to(y.dtype))


def _quant_pool(y, scale, bias, qscale):
    """(N, 64 n, Hc, Wc) f32 conv map -> BN + ReLU + quantize_static with
    trunk i's step qscale[i] on its 64 channels + int8 pool, NHWC."""
    y = torch.relu(y * scale[:, None, None] + bias[:, None, None])
    s = qscale.float().repeat_interleave(64)[:, None, None]
    q = torch.clamp(torch.round(y / s), -127, 127).to(torch.int8)
    return max_pool_int8(q.permute(0, 2, 3, 1))


def stem_pool_q_2d_plain(x, weight, scale, bias, qscale):
    """(N, H, W, C) NHWC, weight (64 n, C, 7, 7), qscale (n,) ->
    (N, H/4, W/4, 64 n) int8 NHWC. The conv runs in f32 whatever the input
    type, as the kernel's does."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), weight.float(), stride=2,
                 padding=3)
    return _quant_pool(y, scale.float(), bias.float(), qscale)


def stem_pool_q_3d_plain(x, weight, scale, bias, qscale):
    """(B, T, H, W), weight (64, 1, 5, 7, 7), qscale (1,) ->
    (B*T, H/4, W/4, 64) int8 NHWC, per-sample temporal zero-pad."""
    y = F.conv3d(x.unsqueeze(1).float(), weight.float(), stride=(1, 2, 2),
                 padding=(2, 3, 3))
    return _quant_pool(y.transpose(1, 2).flatten(0, 1), scale.float(),
                       bias.float(), qscale)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("stem_pool")
    lib.egot2x_stem_pool.restype = ctypes.c_int
    lib.egot2x_stem_pool.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                     + [ctypes.c_void_p])
    lib.egot2x_stem_pool_q.restype = ctypes.c_int
    lib.egot2x_stem_pool_q.argtypes = ([ctypes.c_void_p] * 6
                                       + [ctypes.c_int] * 7
                                       + [ctypes.c_void_p])
    lib.egot2x_cuda_error_string.restype = ctypes.c_char_p
    lib.egot2x_cuda_error_string.argtypes = [ctypes.c_int]
    lib.egot2x_stem_pool_smem_bytes.restype = ctypes.c_int
    lib.egot2x_stem_pool_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def kernel_smem_bytes() -> dict:
    """Dynamic shared memory of one block of each stem kernel, bytes."""
    smem = _library().egot2x_stem_pool_smem_bytes
    return {"2d": smem(2, 0), "3d": smem(3, 0), "q_2d_n1": smem(2, 1),
            "q_2d_n2": smem(2, 2), "q_3d": smem(3, 1)}


def _check_inputs(x, channels, **params):
    if x.dtype not in _DTYPES:
        raise TypeError(
            f"stem kernel takes float32 or bfloat16, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("stem kernel needs a contiguous input")
    for name, v in params.items():
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, input on {x.device}")
    for name in ("scale", "bias"):
        if params[name].shape != (channels,):
            raise ValueError(f"{name} must be ({channels},), got "
                             f"{tuple(params[name].shape)}")


def _raise_on(lib, err):
    if err:
        msg = lib.egot2x_cuda_error_string(err).decode()
        raise RuntimeError(f"stem_pool kernel launch failed: {msg} ({err})")


def _f32(*tensors):
    return [v.float().contiguous() for v in tensors]


def _launch(kind, x, w_taps, scale, bias, b, t, h, w):
    _check_inputs(x, 64, weight=w_taps, scale=scale, bias=bias)
    lib = _library()
    w_taps, scale, bias = _f32(w_taps, scale, bias)
    out = torch.empty((b * t, pooled_size(h), pooled_size(w), 64),
                      dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.egot2x_stem_pool(
            x.data_ptr(), w_taps.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), kind, _DTYPES[x.dtype], b, t, h,
            w, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err)
    return out


def _launch_q(kind, x, w_taps, scale, bias, qscale, b, t, h, w):
    ng = w_taps.shape[0]
    _check_inputs(x, 64 * ng, weight=w_taps, scale=scale, bias=bias,
                  qscale=qscale)
    if qscale.shape != (ng,):
        raise ValueError(f"qscale must be ({ng},), got {tuple(qscale.shape)}")
    lib = _library()
    w_taps, scale, bias, qscale = _f32(w_taps, scale, bias, qscale)
    out = torch.empty((b * t, pooled_size(h), pooled_size(w), 64 * ng),
                      dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.egot2x_stem_pool_q(
            x.data_ptr(), w_taps.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), qscale.data_ptr(), out.data_ptr(), kind,
            _DTYPES[x.dtype], ng, b, t, h, w,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err)
    return out


def _check_device(x):
    if x.device.type != "cuda":
        raise ValueError(f"stem kernel runs on CUDA tensors, not {x.device}")


def stem_pool_2d(x, weight, scale, bias):
    """(N, H, W, 3) NHWC frames, weight (64, 3, 7, 7), BN folded to
    (scale, bias) -> pooled (N, H/4, W/4, 64) NHWC in ``x.dtype``."""
    if x.device.type == "cpu":
        return stem_pool_2d_plain(x, weight, scale, bias)
    _check_device(x)
    n, h, w, c = x.shape
    if c != 3 or weight.shape != (64, 3, 7, 7):
        raise ValueError(f"2D stem takes (N, H, W, 3) and (64, 3, 7, 7), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    # (64, 3, 7, 7) -> (7, 7, 3, 64): the kernel's (kh, kw, ci, co) taps
    out = _launch(2, x, weight.permute(2, 3, 1, 0), scale, bias, n, 1, h, w)
    stem_pool_2d.launches += 1
    return out


def stem_pool_3d(x, weight, scale, bias):
    """(B, T, H, W) grey clips, weight (64, 1, 5, 7, 7), BN folded to
    (scale, bias) -> pooled (B*T, H/4, W/4, 64) NHWC in ``x.dtype``."""
    if x.device.type == "cpu":
        return stem_pool_3d_plain(x, weight, scale, bias)
    _check_device(x)
    b, t, h, w = x.shape
    if weight.shape != (64, 1, 5, 7, 7):
        raise ValueError(f"3D stem weight must be (64, 1, 5, 7, 7), got "
                         f"{tuple(weight.shape)}")
    # (64, 1, 5, 7, 7) -> (5, 7, 7, 64): the kernel's (kt, kh, kw, co) taps
    out = _launch(3, x, weight[:, 0].permute(1, 2, 3, 0), scale, bias, b, t,
                  h, w)
    stem_pool_3d.launches += 1
    return out


def stem_pool_q_2d(x, weight, scale, bias, qscale):
    """(N, H, W, 3) NHWC frames, weight (64 n, 3, 7, 7) of n = 1 or 2
    trunks stacked, BN folded to (scale, bias) (64 n,), qscale (n,) the
    int8 step of each trunk -> pooled int8 (N, H/4, W/4, 64 n) NHWC."""
    if x.device.type == "cpu":
        return stem_pool_q_2d_plain(x, weight, scale, bias, qscale)
    _check_device(x)
    n, h, w, c = x.shape
    ng = weight.shape[0] // 64
    if c != 3 or ng not in (1, 2) or weight.shape != (64 * ng, 3, 7, 7):
        raise ValueError(f"int8 2D stem takes (N, H, W, 3) and (64 n, 3, 7, "
                         f"7) with n 1 or 2, got {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    # (64 n, 3, 7, 7) -> (n, 7, 7, 3, 64): each trunk's (kh, kw, ci, co)
    w_taps = weight.reshape(ng, 64, 3, 7, 7).permute(0, 3, 4, 2, 1)
    out = _launch_q(2, x, w_taps, scale, bias, qscale, n, 1, h, w)
    stem_pool_q_2d.launches += 1
    return out


def stem_pool_q_3d(x, weight, scale, bias, qscale):
    """(B, T, H, W) grey clips, weight (64, 1, 5, 7, 7), BN folded to
    (scale, bias), qscale (1,) the int8 step -> pooled int8
    (B*T, H/4, W/4, 64) NHWC."""
    if x.device.type == "cpu":
        return stem_pool_q_3d_plain(x, weight, scale, bias, qscale)
    _check_device(x)
    b, t, h, w = x.shape
    if weight.shape != (64, 1, 5, 7, 7):
        raise ValueError(f"3D stem weight must be (64, 1, 5, 7, 7), got "
                         f"{tuple(weight.shape)}")
    # (64, 1, 5, 7, 7) -> (1, 5, 7, 7, 64): (kt, kh, kw, co) taps
    w_taps = weight[:, 0].permute(1, 2, 3, 0).unsqueeze(0)
    out = _launch_q(3, x, w_taps, scale, bias, qscale, b, t, h, w)
    stem_pool_q_3d.launches += 1
    return out


stem_pool_2d.launches = 0
stem_pool_3d.launches = 0
stem_pool_q_2d.launches = 0
stem_pool_q_3d.launches = 0

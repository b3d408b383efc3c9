"""Fused stem: stride-2 conv + folded eval-BN + ReLU + 3x3/2 max-pool.

The counterpart of ``egot2x/ops/pallas_stem.py::fused_stem_pool``, the
TPU kernel both frame trunks and TalkNet run their stems through. On a
CUDA tensor each wrapper launches the hand-written Hopper kernel
``csrc/stem_pool.cu``; on a CPU tensor it runs the plain PyTorch version
beside it (``stem_pool_*_plain``), which the tests hold against the JAX
package and the card holds the kernel against.

* ``stem_pool_2d``: ResNet-18 ``conv1`` 7x7/2 pad 3 on (N, H, W, 3) NHWC
  frames -> (N, H/4, W/4, 64) NHWC.
* ``stem_pool_3d``: TalkNet ``frontend3D`` 5x7x7 stride (1, 2, 2) on
  (B, T, H, W) grey clips, temporal zero-pad 2 per sample ->
  (B*T, H/4, W/4, 64) NHWC.

What bounds the kernel on an H100, and what its design does about it, is
in the kernel's source note. In short: it is compute-bound (1.12 TFLOP per
2D trunk at 4800 frames of 224^2, ~16.7 ms at the 67 TFLOP/s of the f32
CUDA cores), so the kernel keeps the pre-pool conv map in shared memory
and spends its device-memory traffic on the input once and the pooled
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

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fold_bn(gamma, beta, mean, var, eps: float):
    """Eval-mode BN as ``y = x * scale + bias`` -> (scale, bias), f32."""
    scale = gamma.float() / torch.sqrt(var.float() + eps)
    return scale, beta.float() - mean.float() * scale


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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("stem_pool")
    lib.egot2x_stem_pool.restype = ctypes.c_int
    lib.egot2x_stem_pool.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                     + [ctypes.c_void_p])
    lib.egot2x_cuda_error_string.restype = ctypes.c_char_p
    lib.egot2x_cuda_error_string.argtypes = [ctypes.c_int]
    lib.egot2x_stem_pool_smem_bytes.restype = ctypes.c_int
    lib.egot2x_stem_pool_smem_bytes.argtypes = [ctypes.c_int]
    return lib


def kernel_smem_bytes() -> dict:
    """Dynamic shared memory of one block of each stem kernel, bytes."""
    lib = _library()
    return {"2d": lib.egot2x_stem_pool_smem_bytes(2),
            "3d": lib.egot2x_stem_pool_smem_bytes(3)}


def _launch(kind, x, w_taps, scale, bias, b, t, h, w):
    if x.dtype not in _DTYPES:
        raise TypeError(
            f"stem kernel takes float32 or bfloat16, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("stem kernel needs a contiguous input")
    for name, v in (("weight", w_taps), ("scale", scale), ("bias", bias)):
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, input on {x.device}")
    if scale.shape != (64,) or bias.shape != (64,):
        raise ValueError("scale and bias must be (64,)")
    lib = _library()
    w_taps = w_taps.float().contiguous()
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    out = torch.empty((b * t, pooled_size(h), pooled_size(w), 64),
                      dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.egot2x_stem_pool(
            x.data_ptr(), w_taps.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), kind, _DTYPES[x.dtype], b, t, h,
            w, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        msg = lib.egot2x_cuda_error_string(err).decode()
        raise RuntimeError(f"stem_pool kernel launch failed: {msg} ({err})")
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


stem_pool_2d.launches = 0
stem_pool_3d.launches = 0

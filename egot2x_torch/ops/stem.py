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

Every variant runs one kernel design, an implicit GEMM on the tensor
cores (``mma.sync`` m16n8k16, f32 sums). The f32 weights of the plain
version are laid out once per loaded weight as the kernel's MMA fragments
(``weight_fragments``, cached by ``_kernel_weights``):

* bf16 input: the exact bf16 frames times bf16 ``w_hi + w_lo``
  (``split_bf16``), two MMAs;
* f32 input, 3xFP16: frames and weights scaled by powers of two into
  fp16's top binade (``pow2_exponent``: the weights per output channel
  here, by ``scale_fp16``; the frames per tile in the kernel) and split
  into fp16 hi + lo (``split_fp16``); x_hi w_hi + x_hi w_lo + x_lo w_hi,
  three MMAs, and the epilogue multiplies the powers of two back, exactly.

What bounds the kernel on an H100, and what its design does about it, is
in the source note of ``csrc/stem_pool.cu``. In short: it is bound by its
operations (111 GFLOP a 2D trunk at 480 frames of 224^2), so it keeps
the pre-pool conv map in shared memory and spends its device-memory
traffic on the input once and the pooled output once.

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


def split_bf16(w):
    """f32 ``w`` as bf16 ``(hi, lo)``: hi = bf16(w), lo = bf16(w - hi), so
    hi + lo is w to ~2^-16 relative. The kernel multiplies the same exact
    bf16 input by both parts and sums in f32."""
    hi = w.float().to(torch.bfloat16)
    return hi, (w.float() - hi.float()).to(torch.bfloat16)


def split_fp16(w):
    """f32 ``w`` as fp16 ``(hi, lo)``: hi = fp16(w), lo = fp16(w - hi), so
    hi + lo is w to ~2^-22 relative where both are normal fp16 (``w``
    scaled by ``pow2_exponent`` first)."""
    hi = w.float().half()
    return hi, (w.float() - hi.float()).half()


# The least scaling exponent (csrc/stem_pool.cu's E_MIN): 2^e of every
# exponent stays a normal f32 power of two, and so does 2^(e_x + e_w)
# wherever the conv's products are finite in f32.
E_MIN = -63


def pow2_exponent(m):
    """The kernel's scaling exponent for a max magnitude ``m`` (f32): e with
    m 2^-e in [2^14, 2^15), fp16's top binade, for m >= 2^-48; -15 at
    m = 0 (frexp(0) has exponent 0); never below ``E_MIN``."""
    _, k = torch.frexp(m.float())
    return torch.clamp(k - 15, min=E_MIN)


def pow2(e):
    """2^e as f32, exact (built from the exponent bits), -126 <= e <= 127."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def scale_fp16(w_taps):
    """(n, ..., 64) f32 taps -> (taps 2^-e_w, 2^e_w (n, 64)) with e_w the
    ``pow2_exponent`` of each trunk's and output channel's max |w|: the
    f32-input kernel's fp16 weights before their split, and the factor its
    epilogue folds into the BN scale."""
    w = w_taps.float()
    e = pow2_exponent(w.abs().amax(dim=tuple(range(1, w.dim() - 1))))
    shape = (e.shape[0],) + (1,) * (w.dim() - 2) + (e.shape[1],)
    return w * pow2(-e).reshape(shape), pow2(e)


def weight_fragments(w_taps, dtype=torch.bfloat16):
    """(n, KT, 7, 7, CIN, 64) f32 taps -> the kernel's weights (n, k-steps,
    8, 32, 8) in ``dtype`` (bf16, or fp16 for taps already scaled by
    ``scale_fp16``): per trunk, k-step s, n-tile nt and lane 4 g + t, the B
    fragments of ``mma.m16n8k16`` for channel 8 nt + g as [hi(k0),
    hi(k0 + 1), hi(k0 + 8), hi(k0 + 9), lo(same four)] with k0 = 16 s + 2 t
    (``split_bf16`` or ``split_fp16``). K is (kt, kh) runs of (kw, ci), each
    run padded with zero taps to 24 (2D) or 8 (3D), then to whole k-steps."""
    ng, kt, _, _, cin, cout = w_taps.shape
    runs, taps, run = kt * 7, 7 * cin, 24 if cin == 3 else 8
    ksteps = (runs * run + 15) // 16
    b = w_taps.float().reshape(ng, runs, taps, cout)
    b = F.pad(b, (0, 0, 0, run - taps)).reshape(ng, runs * run, cout)
    b = F.pad(b, (0, 0, 0, 16 * ksteps - runs * run))
    split = split_fp16 if dtype == torch.float16 else split_bf16
    parts = []
    for part in split(b):
        # k = 16 s + 8 half + 2 t + pair, n = 8 nt + g
        p = part.reshape(ng, ksteps, 2, 4, 2, 8, 8)
        parts.append(p.permute(0, 1, 5, 6, 3, 2, 4))  # (.., nt, g, t, half, pair)
    frags = torch.stack(parts, dim=-3)                # (.., t, part, half, pair)
    return frags.reshape(ng, ksteps, 8, 32, 8).contiguous()


_PREPARED = {}      # (x dtype, weight key) -> (weight, kernel weights)
_PREPARED_MAX = 16


def _kernel_weights(kind, w_taps, dtype):
    """The kernel's weights for input ``dtype`` from (n, KT, 7, 7, CIN, 64)
    taps (2D (n, 7, 7, 3, 64), 3D (1, 5, 7, 7, 64) views): (fragments,
    2^e_w (64 n,) f32 or None). bf16 input takes bf16 fragments of the
    taps; f32 input fp16 fragments of the taps scaled by ``scale_fp16``,
    and the factors. Made once per loaded weight: the cache is keyed on the
    weight's storage, version counter and view, and holds the weight, so
    that a key cannot come back for another tensor."""
    key = (dtype, w_taps.data_ptr(), w_taps._version, w_taps.device,
           tuple(w_taps.shape), w_taps.stride())
    hit = _PREPARED.get(key)
    if hit is None:
        kt, cin = (1, 3) if kind == 2 else (5, 1)
        taps = w_taps.reshape(w_taps.shape[0], kt, 7, 7, cin, 64)
        with torch.no_grad():
            if dtype == torch.bfloat16:
                prepared = (weight_fragments(taps), None)
            else:
                scaled, wexp = scale_fp16(taps)
                prepared = (weight_fragments(scaled, torch.float16),
                            wexp.reshape(-1).contiguous())
        if len(_PREPARED) >= _PREPARED_MAX:
            _PREPARED.pop(next(iter(_PREPARED)))
        hit = _PREPARED[key] = (w_taps, prepared)
    return hit[1]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("stem_pool")
    lib.egot2x_stem_pool.restype = ctypes.c_int
    lib.egot2x_stem_pool.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                                     + [ctypes.c_void_p])
    lib.egot2x_stem_pool_q.restype = ctypes.c_int
    lib.egot2x_stem_pool_q.argtypes = ([ctypes.c_void_p] * 7
                                       + [ctypes.c_int] * 7
                                       + [ctypes.c_void_p])
    lib.egot2x_cuda_error_string.restype = ctypes.c_char_p
    lib.egot2x_cuda_error_string.argtypes = [ctypes.c_int]
    lib.egot2x_stem_pool_smem_bytes.restype = ctypes.c_int
    lib.egot2x_stem_pool_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.egot2x_stem_pool_fragment_elems.restype = ctypes.c_int
    lib.egot2x_stem_pool_fragment_elems.argtypes = [ctypes.c_int]
    return lib


def kernel_smem_bytes() -> dict:
    """Dynamic shared memory of one block of each stem kernel instance,
    bytes: the float stems and the int8 stems (n trunks), by geometry and
    input type."""
    smem = _library().egot2x_stem_pool_smem_bytes
    out = {}
    for dt, code in (("f32", 0), ("bf16", 1)):
        out.update({f"2d_{dt}": smem(2, 0, code), f"3d_{dt}": smem(3, 0, code),
                    f"q_2d_n1_{dt}": smem(2, 1, code),
                    f"q_2d_n2_{dt}": smem(2, 2, code),
                    f"q_3d_{dt}": smem(3, 1, code)})
    return out


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


def _launch(kind, x, w_taps, scale, bias, b, t, h, w, qscale=None):
    """One launch of the float stem (``qscale`` None) or of the int8 stem
    with ``w_taps.shape[0]`` trunks stacked."""
    ng = w_taps.shape[0]
    params = dict(weight=w_taps, scale=scale, bias=bias)
    if qscale is not None:
        params["qscale"] = qscale
    _check_inputs(x, 64 * ng, **params)
    if qscale is not None and qscale.shape != (ng,):
        raise ValueError(f"qscale must be ({ng},), got {tuple(qscale.shape)}")
    lib = _library()
    frags, wexp = _kernel_weights(kind, w_taps, x.dtype)
    if frags.numel() != ng * lib.egot2x_stem_pool_fragment_elems(kind):
        raise RuntimeError("weight fragments disagree with the kernel's K")
    scale, bias = (v.float().contiguous() for v in (scale, bias))
    out = torch.empty((b * t, pooled_size(h), pooled_size(w), 64 * ng),
                      dtype=x.dtype if qscale is None else torch.int8,
                      device=x.device)
    ptrs = [x.data_ptr(), frags.data_ptr(),
            None if wexp is None else wexp.data_ptr(), scale.data_ptr(),
            bias.data_ptr()]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if qscale is None:
            err = lib.egot2x_stem_pool(*ptrs, out.data_ptr(), kind,
                                       _DTYPES[x.dtype], b, t, h, w, stream)
        else:
            qscale = qscale.float().contiguous()
            err = lib.egot2x_stem_pool_q(*ptrs, qscale.data_ptr(),
                                         out.data_ptr(), kind,
                                         _DTYPES[x.dtype], ng, b, t, h, w,
                                         stream)
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
    # (64, 3, 7, 7) -> (1, 7, 7, 3, 64): the kernel's (kh, kw, ci, co) taps
    out = _launch(2, x, weight.permute(2, 3, 1, 0).unsqueeze(0), scale, bias,
                  n, 1, h, w)
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
    # (64, 1, 5, 7, 7) -> (1, 5, 7, 7, 64): the kernel's (kt, kh, kw, co) taps
    out = _launch(3, x, weight[:, 0].permute(1, 2, 3, 0).unsqueeze(0), scale,
                  bias, b, t, h, w)
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
    out = _launch(2, x, w_taps, scale, bias, n, 1, h, w, qscale)
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
    out = _launch(3, x, w_taps, scale, bias, b, t, h, w, qscale)
    stem_pool_q_3d.launches += 1
    return out


stem_pool_2d.launches = 0
stem_pool_3d.launches = 0
stem_pool_q_2d.launches = 0
stem_pool_q_3d.launches = 0

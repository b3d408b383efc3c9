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

Training: the float stems are differentiable. Where autograd would
differentiate them (grad enabled and ``x``, ``weight``, ``scale`` or
``bias`` requiring grad), ``stem_pool_2d``/``stem_pool_3d`` run
``_StemPool``, a ``torch.autograd.Function``. Its forward launches the
kernel's training variant, which also writes each pooled output's winner
in its 3x3 window (uint8, 0-8, the first maximum in row-major order, as
``F.max_pool2d`` picks it) and the winner's conv value ``yw`` (f32); its
backward launches ``stem_pool_backward``, a second hand-written kernel,
which routes dL/dp through the winners and the ReLU to dL/dy on the
pre-pool map (times the BN scale) and sums dL/dbias and dL/dscale per
channel. dL/dweight and dL/dx are the library's convolution gradients of
(x, dy) (``torch.nn.grad``), the products XLA computes in the JAX
package's autodiff of its stems. On the CPU the Function runs the plain
halves, ``stem_pool_{2d,3d}_train_plain`` and ``stem_pool_backward_plain``.
The int8 stems have no backward, as in the JAX package (``quant_trunks``
trains frozen trunks only): they raise on inputs that need grad.

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


def conv_size(n: int) -> int:
    """Edge of the stems' pre-pool conv map: conv 7/2 pad 3."""
    return (n - 1) // 2 + 1


def pooled_size(n: int) -> int:
    """Edge of the pooled map: conv 7/2 pad 3, then pool 3/2 pad 1."""
    return conv_size(conv_size(n))


def _affine_relu(y, scale, bias):
    return torch.relu(y * scale[:, None, None] + bias[:, None, None])


def _pool_affine_relu(y, scale, bias):
    return F.max_pool2d(_affine_relu(y, scale, bias), 3, 2, 1).permute(
        0, 2, 3, 1)


def _pool_affine_relu_train(y, scale, bias):
    """(N, 64, Hc, Wc) conv map -> the pooled (N, Ho, Wo, 64) output, its
    winners' window positions (uint8) and conv values (f32), NHWC."""
    p, idx = F.max_pool2d(_affine_relu(y, scale, bias), 3, 2, 1,
                          return_indices=True)
    ho, wo = p.shape[-2:]
    wc = y.shape[-1]
    po = torch.arange(ho, device=y.device).view(ho, 1)
    pc = torch.arange(wo, device=y.device).view(1, wo)
    win = (idx // wc - (2 * po - 1)) * 3 + idx % wc - (2 * pc - 1)
    yw = y.flatten(2).gather(2, idx.flatten(2)).view(p.shape).float()
    return tuple(v.permute(0, 2, 3, 1) for v in (p, win.to(torch.uint8), yw))


def stem_pool_2d_plain(x, weight, scale, bias):
    """(N, H, W, C) NHWC, weight (64, C, 7, 7) -> (N, H/4, W/4, 64) NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), stride=2,
                 padding=3)
    return _pool_affine_relu(y, scale.to(y.dtype), bias.to(y.dtype))


def _conv3d_frames(x, weight):
    """The 3D stem's conv over each clip on its own (per-sample temporal
    zero-pad) -> (B*T, 64, Hc, Wc)."""
    y = F.conv3d(x.unsqueeze(1), weight.to(x.dtype), stride=(1, 2, 2),
                 padding=(2, 3, 3))                      # (B, 64, T, Hc, Wc)
    return y.transpose(1, 2).flatten(0, 1)


def stem_pool_3d_plain(x, weight, scale, bias):
    """(B, T, H, W), weight (64, 1, 5, 7, 7) -> (B*T, H/4, W/4, 64) NHWC.
    The conv runs over each clip on its own, so the temporal zero-pad is
    per sample."""
    y = _conv3d_frames(x, weight)
    return _pool_affine_relu(y, scale.to(y.dtype), bias.to(y.dtype))


def stem_pool_2d_train_plain(x, weight, scale, bias):
    """The training forward's plain half, 2D: ``stem_pool_2d_plain``'s
    output, and each output's winner 0-8 in its 3x3 window (uint8, from
    ``F.max_pool2d``'s indices: the first maximum in row-major order) and
    the winner's conv value (f32), all (N, H/4, W/4, 64)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), stride=2,
                 padding=3)
    return _pool_affine_relu_train(y, scale.to(y.dtype), bias.to(y.dtype))


def stem_pool_3d_train_plain(x, weight, scale, bias):
    """The training forward's plain half, 3D, as the 2D one."""
    y = _conv3d_frames(x, weight)
    return _pool_affine_relu_train(y, scale.to(y.dtype), bias.to(y.dtype))


def stem_pool_backward_plain(dp, p, win, yw, scale, conv_hw):
    """The backward's plain half: dL/dp (N, Ho, Wo, 64), the pooled
    output p, the winners and their conv values, the BN scale (64,) ->
    (dL/dy (N, Hc, Wc, 64) f32 on the pre-pool conv map, dL/dscale,
    dL/dbias (64,) f32). Each output's gradient, where p > 0 (ReLU passes
    it), goes to its winner, times the scale."""
    hc, wc = conv_hw
    n, ho, wo, c = dp.shape
    g = torch.where(p > 0, dp.float(), torch.zeros((), device=dp.device))
    k = win.long()
    po = torch.arange(ho, device=dp.device).view(1, ho, 1, 1)
    pc = torch.arange(wo, device=dp.device).view(1, 1, wo, 1)
    flat = (2 * po - 1 + k // 3) * wc + 2 * pc - 1 + k % 3
    dz = torch.zeros(n, hc * wc, c, device=dp.device).scatter_add_(
        1, flat.reshape(n, -1, c), g.reshape(n, -1, c))
    return ((dz * scale.float()).view(n, hc, wc, c),
            (g * yw).sum((0, 1, 2)), g.sum((0, 1, 2)))


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
    weight's storage, version counter and view, and holds the weight (a
    detached view, free of autograd history), so that a key cannot come
    back for another tensor."""
    key = (dtype, w_taps.data_ptr(), w_taps._version, w_taps.device,
           tuple(w_taps.shape), w_taps.stride())
    # an in-place update of the weight (an optimizer step) bumps its
    # version, so the fragments are made again
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
        hit = _PREPARED[key] = (w_taps.detach(), prepared)
    return hit[1]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("stem_pool")
    lib.egot2x_stem_pool.restype = ctypes.c_int
    lib.egot2x_stem_pool.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                                     + [ctypes.c_void_p])
    lib.egot2x_stem_pool_train.restype = ctypes.c_int
    lib.egot2x_stem_pool_train.argtypes = ([ctypes.c_void_p] * 8
                                           + [ctypes.c_int] * 6
                                           + [ctypes.c_void_p])
    lib.egot2x_stem_pool_backward.restype = ctypes.c_int
    lib.egot2x_stem_pool_backward.argtypes = ([ctypes.c_void_p] * 8
                                              + [ctypes.c_int] * 4
                                              + [ctypes.c_void_p])
    lib.egot2x_stem_pool_backward_blocks.restype = ctypes.c_int
    lib.egot2x_stem_pool_backward_blocks.argtypes = [ctypes.c_int] * 3
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
    bytes: the float stems (inference and training) and the int8 stems (n
    trunks), by geometry and input type."""
    smem = _library().egot2x_stem_pool_smem_bytes
    out = {}
    for dt, code in (("f32", 0), ("bf16", 1)):
        out.update({f"2d_{dt}": smem(2, 0, code), f"3d_{dt}": smem(3, 0, code),
                    f"2d_{dt}_train": smem(2, -1, code),
                    f"3d_{dt}_train": smem(3, -1, code),
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


def _launch(kind, x, w_taps, scale, bias, b, t, h, w, qscale=None,
            train=False):
    """One launch of the float stem (``qscale`` None; ``train``: its
    training variant, which returns (out, winners, their conv values)) or
    of the int8 stem with ``w_taps.shape[0]`` trunks stacked."""
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
        if train:
            win = torch.empty(out.shape, dtype=torch.uint8, device=x.device)
            yw = torch.empty(out.shape, dtype=torch.float32, device=x.device)
            err = lib.egot2x_stem_pool_train(
                *ptrs, out.data_ptr(), win.data_ptr(), yw.data_ptr(), kind,
                _DTYPES[x.dtype], b, t, h, w, stream)
            out = (out, win, yw)
        elif qscale is None:
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


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(v.requires_grad for v in tensors)


def _float_geometry(kind, x, weight):
    """(the kernel's (1, KT, 7, 7, CIN, 64)-ordered taps view of
    ``weight``, b, t, h, w) of a float stem call; raises on what the kernel
    does not take."""
    if kind == 2:
        n, h, w, c = x.shape
        if c != 3 or weight.shape != (64, 3, 7, 7):
            raise ValueError(f"2D stem takes (N, H, W, 3) and (64, 3, 7, 7), "
                             f"got {tuple(x.shape)} and "
                             f"{tuple(weight.shape)}")
        # (64, 3, 7, 7) -> (1, 7, 7, 3, 64): the kernel's (kh, kw, ci, co)
        return weight.permute(2, 3, 1, 0).unsqueeze(0), n, 1, h, w
    b, t, h, w = x.shape
    if weight.shape != (64, 1, 5, 7, 7):
        raise ValueError(f"3D stem weight must be (64, 1, 5, 7, 7), got "
                         f"{tuple(weight.shape)}")
    # (64, 1, 5, 7, 7) -> (1, 5, 7, 7, 64): the kernel's (kt, kh, kw, co)
    return weight[:, 0].permute(1, 2, 3, 0).unsqueeze(0), b, t, h, w


_TRAIN_PLAIN = {2: stem_pool_2d_train_plain, 3: stem_pool_3d_train_plain}


def stem_pool_backward(dp, p, win, yw, scale, conv_hw):
    """``stem_pool_backward_plain``'s function: on a CUDA tensor the
    backward kernel of ``csrc/stem_pool.cu`` (its first pass routes and
    sums per block, its second sums the blocks), on a CPU tensor the plain
    version. dL/dp and p in the stem's output type, f32 out."""
    if dp.device.type == "cpu":
        return stem_pool_backward_plain(dp, p, win, yw, scale, conv_hw)
    _check_device(dp)
    hc, wc = conv_hw
    n, ho, wo, c = p.shape
    if (c != 64 or dp.shape != p.shape or win.shape != p.shape
            or yw.shape != p.shape or (ho, wo) != (conv_size(hc),
                                                   conv_size(wc))):
        raise ValueError(f"stem backward takes dp, p, winners and values of "
                         f"one (N, Ho, Wo, 64) shape over a ({hc}, {wc}) "
                         f"conv map, got {tuple(dp.shape)}, "
                         f"{tuple(p.shape)}, {tuple(win.shape)}, "
                         f"{tuple(yw.shape)}")
    if (p.dtype not in _DTYPES or dp.dtype != p.dtype
            or win.dtype != torch.uint8 or yw.dtype != torch.float32):
        raise TypeError(f"stem backward takes f32 or bf16 dp and p of one "
                        f"dtype, uint8 winners and f32 values, got "
                        f"{dp.dtype}, {p.dtype}, {win.dtype}, {yw.dtype}")
    if scale.shape != (64,):
        raise ValueError(f"scale must be (64,), got {tuple(scale.shape)}")
    lib = _library()
    dp, p, win, yw = (v.contiguous() for v in (dp, p, win, yw))
    scale = scale.float().contiguous()
    for name, v in (("p", p), ("winners", win), ("values", yw),
                    ("scale", scale)):
        if v.device != dp.device:
            raise ValueError(f"{name} is on {v.device}, dp on {dp.device}")
    blocks = lib.egot2x_stem_pool_backward_blocks(n, hc, wc)
    if blocks < 1:
        raise RuntimeError("stem backward: no launch geometry")
    dy = torch.empty((n, hc, wc, 64), dtype=torch.float32, device=dp.device)
    partial = torch.empty((blocks, 2, 64), dtype=torch.float32,
                          device=dp.device)
    sums = torch.empty((2, 64), dtype=torch.float32, device=dp.device)
    with torch.cuda.device(dp.device):
        err = lib.egot2x_stem_pool_backward(
            dp.data_ptr(), p.data_ptr(), win.data_ptr(), yw.data_ptr(),
            scale.data_ptr(), dy.data_ptr(), partial.data_ptr(),
            sums.data_ptr(), _DTYPES[p.dtype], n, hc, wc,
            torch.cuda.current_stream(dp.device).cuda_stream)
    _raise_on(lib, err)
    stem_pool_backward.launches += 1
    return dy, sums[1], sums[0]


def frame_taps(x):
    """(B, T, H, W) clips -> (B*T, H, W, 5): each frame's 5 temporal taps
    (frames t - 2 .. t + 2 of its clip, zero past the clip's ends) as
    channels, f32."""
    b, t, h, w = x.shape
    padded = F.pad(x.float(), (0, 0, 0, 0, 2, 2))       # (B, T + 4, H, W)
    return padded.unfold(1, 5, 1).reshape(b * t, h, w, 5)


def _conv_grads(kind, x, weight, dy, need_x, need_w):
    """(dL/dx, dL/dweight) of the stem's conv from dL/dy on its pre-pool
    map (N, Hc, Wc, 64) f32: the library's convolution gradients, in f32
    (the parameters' type), dL/dx in x's type; None where not needed. The
    3D weight gradient is taken as a 2D one over each frame's 5 temporal
    taps unfolded into channels (the same sums: the 3D conv's weight
    (64, 1, 5, 7, 7) is the 2D conv's (64, 5, 7, 7)), since cuDNN's f32 3D
    weight gradient with one input channel is ~20x slower on an H100."""
    dx = dw = None
    dyn = dy.permute(0, 3, 1, 2)                         # channels_last view
    if kind == 2:
        xin = x.permute(0, 3, 1, 2)
        if need_w:
            dw = torch.nn.grad.conv2d_weight(xin.float(), weight.shape, dyn,
                                             stride=2, padding=3)
        if need_x:
            dx = torch.nn.grad.conv2d_input(xin.shape, weight.float(), dyn,
                                            stride=2, padding=3)
            dx = dx.permute(0, 2, 3, 1).to(x.dtype)
        return dx, dw
    if need_w:
        taps = frame_taps(x).permute(0, 3, 1, 2)
        dw = torch.nn.grad.conv2d_weight(taps, (64, 5, 7, 7), dyn, stride=2,
                                         padding=3).view(weight.shape)
    if need_x:
        b, t = x.shape[:2]
        dx = torch.nn.grad.conv3d_input(
            x.unsqueeze(1).shape, weight.float(),
            dyn.reshape(b, t, *dyn.shape[1:]).transpose(1, 2),
            stride=(1, 2, 2), padding=(2, 3, 3))[:, 0].to(x.dtype)
    return dx, dw


class _StemPool(torch.autograd.Function):
    """The float stem with its gradient; ``kind`` 2 or 3. The forward saves
    the pooled output, the winners and their conv values (not the pre-pool
    map: at 480 frames of 224^2, 96 MB of winners and 385 MB of values a
    2D trunk against the map's 1.54 GB in f32)."""

    @staticmethod
    def forward(ctx, kind, x, weight, scale, bias):
        if x.device.type == "cpu":
            out, win, yw = _TRAIN_PLAIN[kind](x, weight, scale, bias)
        else:
            _check_device(x)
            w_taps, b, t, h, w = _float_geometry(kind, x, weight)
            out, win, yw = _launch(kind, x, w_taps, scale, bias, b, t, h, w,
                                   train=True)
            (stem_pool_2d if kind == 2 else stem_pool_3d).launches += 1
        ctx.kind = kind
        ctx.save_for_backward(x, weight, scale, out, win, yw)
        return out

    @staticmethod
    def backward(ctx, dp):
        x, weight, scale, out, win, yw = ctx.saved_tensors
        h, w = x.shape[-3:-1] if ctx.kind == 2 else x.shape[-2:]
        dy, dscale, dbias = stem_pool_backward(
            dp, out, win, yw, scale, (conv_size(h), conv_size(w)))
        dx, dw = _conv_grads(ctx.kind, x, weight, dy,
                             ctx.needs_input_grad[1], ctx.needs_input_grad[2])
        return None, dx, dw, dscale, dbias


def stem_pool_2d(x, weight, scale, bias):
    """(N, H, W, 3) NHWC frames, weight (64, 3, 7, 7), BN folded to
    (scale, bias) -> pooled (N, H/4, W/4, 64) NHWC in ``x.dtype``.
    Differentiable (``_StemPool``) where autograd would differentiate it."""
    if _needs_grad(x, weight, scale, bias):
        return _StemPool.apply(2, x, weight, scale, bias)
    if x.device.type == "cpu":
        return stem_pool_2d_plain(x, weight, scale, bias)
    _check_device(x)
    w_taps, b, t, h, w = _float_geometry(2, x, weight)
    out = _launch(2, x, w_taps, scale, bias, b, t, h, w)
    stem_pool_2d.launches += 1
    return out


def stem_pool_3d(x, weight, scale, bias):
    """(B, T, H, W) grey clips, weight (64, 1, 5, 7, 7), BN folded to
    (scale, bias) -> pooled (B*T, H/4, W/4, 64) NHWC in ``x.dtype``.
    Differentiable (``_StemPool``) where autograd would differentiate it."""
    if _needs_grad(x, weight, scale, bias):
        return _StemPool.apply(3, x, weight, scale, bias)
    if x.device.type == "cpu":
        return stem_pool_3d_plain(x, weight, scale, bias)
    _check_device(x)
    w_taps, b, t, h, w = _float_geometry(3, x, weight)
    out = _launch(3, x, w_taps, scale, bias, b, t, h, w)
    stem_pool_3d.launches += 1
    return out


def _no_grad_int8(*tensors):
    if _needs_grad(*tensors):
        raise ValueError("the int8 stem has no backward: its input, weight "
                         "or BN requires grad (int8 trunks train frozen)")


def stem_pool_q_2d(x, weight, scale, bias, qscale):
    """(N, H, W, 3) NHWC frames, weight (64 n, 3, 7, 7) of n = 1 or 2
    trunks stacked, BN folded to (scale, bias) (64 n,), qscale (n,) the
    int8 step of each trunk -> pooled int8 (N, H/4, W/4, 64 n) NHWC.
    Raises on inputs that need grad."""
    _no_grad_int8(x, weight, scale, bias, qscale)
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
    (B*T, H/4, W/4, 64) NHWC. Raises on inputs that need grad."""
    _no_grad_int8(x, weight, scale, bias, qscale)
    if x.device.type == "cpu":
        return stem_pool_q_3d_plain(x, weight, scale, bias, qscale)
    _check_device(x)
    w_taps, b, t, h, w = _float_geometry(3, x, weight)
    out = _launch(3, x, w_taps, scale, bias, b, t, h, w, qscale)
    stem_pool_q_3d.launches += 1
    return out


stem_pool_2d.launches = 0
stem_pool_3d.launches = 0
stem_pool_q_2d.launches = 0
stem_pool_q_3d.launches = 0
stem_pool_backward.launches = 0

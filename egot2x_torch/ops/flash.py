"""Flash attention: unmasked softmax(Q K^T / sqrt(D)) V, streamed over keys.

Counterpart of the TPU kernel ``egot2x/ops/pallas_attention.py::
flash_attention``. On a CUDA tensor ``flash_attention`` launches the
hand-written Hopper kernel of ``csrc/flash_attention.cu``; on a CPU tensor
it runs the plain PyTorch version beside it (``flash_attention_plain``),
which the tests hold against the JAX package and the card holds the
kernel against.

Two layouts, one function:

* (BH, N, D) q and (BH, S, D) k, v -> (BH, N, D), the JAX kernel's;
* (B, N, H, D) q and (B, S, H, D) k, v -> (B, N, H, D), the port's
  multi-head layout, which the kernel reads in place through strides.

f32 or bf16 in, f32 logits, max, sum and accumulator, output in q's
dtype; any N, S, D >= 1; forward only. The kernel runs both products on
the tensor cores (``mma.sync``: bf16 input as it is, f32 input as 3xTF32,
which holds the f32 gate); its bound is the exponentials. What its design
does about that is in its source note. A head dim past 128 takes a second
body that works on D in chunks of 128.

``flash_attention.launches`` counts kernel launches (CPU calls do not
count), so a run can show that its attention went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from egot2x_torch.ops import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v):
    """The same function in plain PyTorch: q scaled before the dot, f32
    logits and softmax, f32 P V, output in q's dtype."""
    heads_last = q.dim() == 4
    if heads_last:
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    out = torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)
    return out.transpose(1, 2).contiguous() if heads_last else out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.egot2x_flash_attention.restype = ctypes.c_int
    lib.egot2x_flash_attention.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    lib.egot2x_flash_attention_smem_bytes.restype = ctypes.c_int
    lib.egot2x_flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.egot2x_flash_error_string.restype = ctypes.c_char_p
    lib.egot2x_flash_error_string.argtypes = [ctypes.c_int]
    return lib


def kernel_smem_bytes(d: int, dtype=torch.float32) -> int:
    """Dynamic shared memory of one block at head dim ``d``, bytes."""
    return _library().egot2x_flash_attention_smem_bytes(d, _DTYPES[dtype])


def _geometry(q, k, v):
    """(batch, heads, N, S, D) of either layout; raises on what the kernel
    does not take."""
    if q.dim() not in (3, 4) or k.shape != v.shape or k.dim() != q.dim():
        raise ValueError(f"flash attention takes (BH, N, D) or (B, N, H, D) "
                         f"q with k, v alike, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dim() == 3:
        (bh, n, d), (bk, s, dk) = q.shape, k.shape
        batch, heads = bh, 1
        same = bk == bh and dk == d
    else:
        (batch, n, heads, d), (bk, s, hk, dk) = q.shape, k.shape
        same = bk == batch and hk == heads and dk == d
    if not same:
        raise ValueError(f"q {tuple(q.shape)} and k, v {tuple(k.shape)} "
                         "differ outside the sequence axis")
    if d < 1 or n < 1 or s < 1:
        raise ValueError(f"flash kernel takes non-empty sequences and head "
                         f"dims, got N {n}, S {s}, D {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise TypeError(f"flash kernel takes float32 or bfloat16 q, k, "
                            f"v of one dtype; {name} is {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last axis")
    return batch, heads, n, s, d


def _strides(x):
    """(batch, head, row) element strides of either layout."""
    if x.dim() == 3:
        return x.stride(0), 0, x.stride(1)
    return x.stride(0), x.stride(2), x.stride(1)


def flash_attention(q, k, v):
    """softmax(q k^T / sqrt(D)) v over (BH, N, D) or (B, N, H, D) inputs,
    in q's layout and dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise. The kernel has no backward: it
    raises on inputs that autograd would differentiate, on either device,
    rather than return an output whose gradient was dropped."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise ValueError("flash_attention has no backward: q, k or v "
                         "requires grad")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel runs on CUDA tensors, not {q.device}")
    batch, heads, n, s, d = _geometry(q, k, v)
    lib = _library()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.egot2x_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], batch * heads, heads, n, s, d, *_strides(q),
            *_strides(k), *_strides(v), *_strides(out),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        msg = lib.egot2x_flash_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} "
                           f"({err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

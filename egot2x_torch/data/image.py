"""The data plane: JPEG decode and encode, crop and resize, normalisation.

Counterpart of the JAX package's host data plane (``egot2x/native/
dataplane.cpp`` and its bindings, ``egot2x/native/__init__.py:67-100``),
and of the ``cv2.imread`` / ``cv2.resize`` / ``cv2.imwrite`` calls of its
datasets. The device is explicit in every call and picks the route:

  * on the card, frames are decoded by nvJPEG into device memory as RGB
    (``csrc/jpeg.cu``, one nvJPEG context per host thread: its decode state
    is not thread-safe, and the loaders build items in a thread pool), and
    :func:`crop_resize` launches the hand-written ``crop_resize`` kernel;
    nothing gives way to cv2 or to the plain version there;
  * on the CPU, frames are decoded by ``cv2.imread`` (imported here, only
    on that route) and :func:`crop_resize` runs its plain version,
    :func:`crop_resize_plain`, the same integer arithmetic.

Frames are (H, W, 3) uint8 RGB tensors, or (H, W) grey. ``crop_resize``
follows ``dataplane.cpp:73-130`` exactly (half-pixel centres, 11-bit
fixed-point weights, two passes, its rounding), so its pixels are the JAX
package's native plane's bit for bit, and within 2 of ``cv2.resize``'s
(the bar ``tests/test_native.py`` holds that plane to).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
ONE = 1 << 11                     # dataplane.cpp's fixed-point weights
GREY = (4899, 9617, 1868)         # cv2's 14-bit R, G, B weights
FILL_CLAMP = -1                   # ``fill`` that clamps the box instead
# the loaders' threads decode and launch: their counts add under a lock
_COUNTS = threading.Lock()


def _library() -> ctypes.CDLL:
    from egot2x_torch.ops import build

    lib = build.load("jpeg")
    vp, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    ip = ctypes.POINTER(ctypes.c_int)
    lib.egot2x_jpeg_version.argtypes = [ip, ip, ip]
    lib.egot2x_jpeg_context_create.argtypes = [ctypes.POINTER(vp)]
    lib.egot2x_jpeg_context_destroy.argtypes = [vp]
    lib.egot2x_jpeg_info.argtypes = [vp, ctypes.c_char_p, sz, ip, ip, ip]
    lib.egot2x_jpeg_decode_rgbi.argtypes = [vp, ctypes.c_char_p, sz, vp, i,
                                            vp]
    lib.egot2x_jpeg_encode_rgbi.argtypes = [vp, vp, i, i, i, vp, sz,
                                            ctypes.POINTER(sz), vp]
    lib.egot2x_crop_resize.argtypes = [vp, i, i, i, vp, vp]
    for fn in (lib.egot2x_jpeg_version, lib.egot2x_jpeg_context_create,
               lib.egot2x_jpeg_context_destroy, lib.egot2x_jpeg_info,
               lib.egot2x_jpeg_decode_rgbi, lib.egot2x_jpeg_encode_rgbi,
               lib.egot2x_crop_resize):
        fn.restype = ctypes.c_int   # 0, nvJPEG's status or 1000 + CUDA's
    return lib


def _check(status: int, what: str) -> None:
    if status:
        kind = (f"CUDA error {status - 1000}" if status >= 1000
                else f"nvJPEG status {status}")
        raise RuntimeError(f"{what} failed: {kind}")


def nvjpeg_version() -> str:
    """nvJPEG's version, ``major.minor.patch`` (``nvjpegGetProperty``)."""
    v = [ctypes.c_int() for _ in range(3)]
    _check(_library().egot2x_jpeg_version(*map(ctypes.byref, v)),
           "nvjpegGetProperty")
    return ".".join(str(x.value) for x in v)


class _Context:
    """One nvJPEG context (handle, decode and encoder states) on one card,
    held by one thread at a time: taken from that card's free list on a
    thread's first call there, given back when the thread ends. Created
    with its card current, as nvJPEG allocates on the current device."""

    free: Dict[int, list] = {}
    lock = threading.Lock()

    def __init__(self, index: int):
        self.index = index
        with self.lock:
            pool = self.free.setdefault(index, [])
            self.ptr = pool.pop() if pool else None
        if self.ptr is None:
            ptr = ctypes.c_void_p()
            with torch.cuda.device(index):
                _check(_library().egot2x_jpeg_context_create(
                    ctypes.byref(ptr)), "nvJPEG context")
            self.ptr = ptr

    def __del__(self):
        with self.lock:
            self.free[self.index].append(self.ptr)


_LOCAL = threading.local()


def _context(device: torch.device) -> ctypes.c_void_p:
    """This thread's nvJPEG context on ``device`` (an indexed card)."""
    contexts = getattr(_LOCAL, "contexts", None)
    if contexts is None:
        contexts = _LOCAL.contexts = {}
    if device.index not in contexts:
        contexts[device.index] = _Context(device.index)
    return contexts[device.index].ptr


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _device(device) -> torch.device:
    """``device`` as a torch.device; a card without an index is the
    current one, so that every call below names its card."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no data plane for device {device}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def decode_jpeg(data: bytes, device) -> torch.Tensor:
    """A JPEG's bytes -> (H, W, 3) uint8 RGB on the card, by nvJPEG."""
    device = _device(device)
    if device.type != "cuda":
        raise ValueError("decode_jpeg decodes on the card; read_jpeg "
                         "decodes on the CPU with cv2")
    lib, ctx = _library(), _context(device)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):   # nvJPEG runs on the current card
        _check(lib.egot2x_jpeg_info(ctx, data, len(data), ctypes.byref(w),
                                    ctypes.byref(h), ctypes.byref(c)),
               "nvjpegGetImageInfo")
        out = torch.empty((h.value, w.value, 3), dtype=torch.uint8,
                          device=device)
        _check(lib.egot2x_jpeg_decode_rgbi(ctx, data, len(data),
                                           out.data_ptr(), w.value,
                                           _stream(device)), "nvjpegDecode")
    with _COUNTS:
        decode_jpeg.decodes += 1
    return out


decode_jpeg.decodes = 0


def read_jpeg(path: str, device) -> torch.Tensor:
    """The JPEG at ``path`` -> (H, W, 3) uint8 RGB on ``device``: nvJPEG on
    the card, ``cv2.imread`` on the CPU."""
    device = _device(device)
    if device.type == "cuda":
        with open(path, "rb") as f:
            return decode_jpeg(f.read(), device)
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise OSError(f"cv2 could not read {path}")
    return torch.from_numpy(np.ascontiguousarray(img[..., ::-1]))


def encode_jpeg(rgb: torch.Tensor, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 RGB on the card -> a baseline JPEG's bytes, by
    nvJPEG's encoder at cv2.imwrite's defaults (quality 95, 4:2:0)."""
    if rgb.device.type != "cuda":
        raise ValueError("encode_jpeg encodes on the card")
    if rgb.dtype != torch.uint8 or rgb.dim() != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {tuple(rgb.shape)} "
                         f"{rgb.dtype}")
    rgb = rgb.contiguous()
    h, w = rgb.shape[:2]
    cap = 2 * h * w * 3 + (1 << 16)   # more than any baseline JPEG of it
    buf = ctypes.create_string_buffer(cap)
    n = ctypes.c_size_t()
    device = _device(rgb.device)
    with torch.cuda.device(device):
        _check(_library().egot2x_jpeg_encode_rgbi(
            _context(device), rgb.data_ptr(), w, h, quality, buf, cap,
            ctypes.byref(n), _stream(device)), "nvjpegEncodeImage")
    return buf.raw[:n.value]


def write_jpeg(path: str, rgb: np.ndarray, device) -> None:
    """Write (H, W, 3) uint8 RGB ``rgb`` as a JPEG: nvJPEG's encoder on the
    card, ``cv2.imwrite`` (quality 95, 4:2:0) on the CPU."""
    device = _device(device)
    if device.type == "cuda":
        data = encode_jpeg(torch.from_numpy(np.ascontiguousarray(rgb)).to(
            device))
        with open(path, "wb") as f:
            f.write(data)
        return
    import cv2

    if not cv2.imwrite(path, np.ascontiguousarray(rgb[..., ::-1])):
        raise OSError(f"cv2 could not write {path}")


def _items(frames, boxes, grey, flip, fill) -> np.ndarray:
    """The kernel's per-frame words (see ``csrc/jpeg.cu``'s Item)."""
    boxes = np.ascontiguousarray(boxes, dtype=np.float32).reshape(-1, 4)
    items = np.zeros((len(frames), 8), np.int64)
    bits = boxes.view(np.int32).astype(np.int64)
    for k, (img, f) in enumerate(zip(frames, flip)):
        h, w = img.shape[:2]
        c = img.shape[2] if img.dim() == 3 else 1
        items[k, :3] = (img.data_ptr(), w | h << 20 | c << 40,
                        int(grey) | int(f) << 1 | (fill + 1) << 8)
    items[:, 3:7] = bits
    return items


def _args(frames, boxes, grey, flip, fill):
    frames = list(frames)
    if len(frames) != len(np.asarray(boxes).reshape(-1, 4)):
        raise ValueError("one box a frame")
    flips = ([bool(flip)] * len(frames) if np.ndim(flip) == 0
             else [bool(f) for f in flip])
    fill = FILL_CLAMP if fill is None else int(fill)
    if not FILL_CLAMP <= fill <= 255:
        raise ValueError(f"fill {fill} is not a uint8 value")
    for img in frames:
        if img.dtype != torch.uint8 or img.dim() not in (2, 3) or (
                img.dim() == 3 and img.shape[2] not in (1, 3)):
            raise ValueError(f"expected (H, W[, 1 or 3]) uint8 frames, got "
                             f"{tuple(img.shape)} {img.dtype}")
    channels = {img.shape[2] if img.dim() == 3 else 1 for img in frames}
    if len(channels) > 1:
        raise ValueError("frames of one call share their channels")
    out_c = 1 if grey or channels == {1} else 3
    return frames, flips, fill, out_c


def crop_resize(frames: Sequence[torch.Tensor], boxes, size: int,
                grey: bool = False,
                flip: Union[bool, Sequence[bool]] = False,
                fill: Optional[int] = None) -> torch.Tensor:
    """Crop each frame to its box and resize it to ``size`` x ``size``:
    (n, size, size, C) uint8, C 1 for ``grey`` (or grey frames), else 3.

    ``boxes``: (n, 4) x1, y1, x2, y2, as float32, the crop [int(x1),
    int(x2)) x [int(y1), int(y2)) (truncated, as C truncates); ``grey``:
    convert RGB to grey first (cv2's COLOR_BGR2GRAY weights); ``flip``:
    mirror the output left to right (one flag, or one a frame); ``fill``:
    None clamps the box to the frame, a uint8 value reads taps outside the
    frame as that value (np.pad's constant). An empty box gives zeros.
    On the card one launch of the ``crop_resize`` kernel serves every frame
    (counted in ``crop_resize.launches``); on the CPU the plain version."""
    frames, flips, fill, out_c = _args(frames, boxes, grey, flip, fill)
    n = len(frames)
    device = frames[0].device if n else torch.device("cpu")
    if any(f.device != device for f in frames):
        raise ValueError("frames of one call lie on one device")
    if device.type == "cpu":
        return crop_resize_plain(frames, boxes, size, grey, flips, fill)
    if device.type != "cuda":
        raise ValueError(f"no crop_resize for device {device}")
    if n > 65535:   # one block row a frame in the grid's z
        raise ValueError(f"{n} frames in one launch; at most 65535")
    out = torch.empty((n, size, size, out_c), dtype=torch.uint8,
                      device=device)
    if n == 0:
        return out
    frames = [f.contiguous() for f in frames]
    items = torch.from_numpy(_items(frames, boxes, grey, flips, fill)).to(
        device)
    launch(items, out)
    return out


def launch(items: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of the ``crop_resize`` kernel: ``items`` (n, 8) int64 on
    the card (``_items``' words; the frames they point to alive until the
    kernel has run) into ``out`` (n, s, s, C) uint8, on the current
    stream; counted in ``crop_resize.launches``."""
    n, size, _, out_c = out.shape
    if (items.dtype != torch.int64 or tuple(items.shape) != (n, 8)
            or items.device != out.device or out.dtype != torch.uint8
            or not (items.is_contiguous() and out.is_contiguous())):
        raise ValueError("crop_resize takes (n, 8) int64 words and a "
                         "contiguous (n, s, s, C) uint8 output on one card")
    with torch.cuda.device(out.device):   # launched on the output's card
        _check(_library().egot2x_crop_resize(items.data_ptr(), n, size,
                                             out_c, out.data_ptr(),
                                             _stream(out.device)),
               "crop_resize")
    with _COUNTS:
        crop_resize.launches += 1


crop_resize.launches = 0


def _taps(o: torch.Tensor, size: int, length: int, device):
    """dataplane.cpp's source index, next index and 11-bit weight of
    output positions ``o``, in float32 as it computes them (on the CPU,
    whose division is C's; CUDA divides by a scalar as a product with its
    reciprocal), then on ``device``."""
    scale = torch.tensor(length, dtype=torch.float32) / size
    f = ((o.to(torch.float32) + 0.5) * scale - 0.5).clamp_min(0.0)
    i0 = f.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=length - 1)
    w = ((f - i0.to(torch.float32)) * ONE + 0.5).to(torch.int64)
    return i0.to(device), i1.to(device), w.to(device)


def crop_resize_plain(frames: Sequence[torch.Tensor], boxes, size: int,
                      grey: bool = False,
                      flip: Union[bool, Sequence[bool]] = False,
                      fill: Optional[int] = None) -> torch.Tensor:
    """:func:`crop_resize`'s plain version: the kernel's integer arithmetic
    frame by frame in PyTorch, on the frames' device (``fill`` -1 clamps,
    as None does)."""
    frames, flips, fill, out_c = _args(frames, boxes, grey, flip,
                                       None if fill == FILL_CLAMP else fill)
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    device = frames[0].device if frames else torch.device("cpu")
    out = torch.zeros((len(frames), size, size, out_c), dtype=torch.uint8,
                      device=device)
    o = torch.arange(size)
    for k, (img, box, f) in enumerate(zip(frames, boxes, flips)):
        img = img[..., None] if img.dim() == 2 else img
        h, w = img.shape[:2]
        x1, y1, x2, y2 = (int(v) for v in box)
        if fill == FILL_CLAMP:
            x1, y1, x2, y2 = max(0, x1), max(0, y1), min(w, x2), min(h, y2)
        cw, ch = x2 - x1, y2 - y1
        if cw <= 0 or ch <= 0:
            continue
        # the box's pixels, fill where it lies past the frame
        crop = torch.full((ch, cw, out_c), max(fill, 0), dtype=torch.int64,
                          device=device)
        ya0, ya1, xa0, xa1 = max(y1, 0), min(y2, h), max(x1, 0), min(x2, w)
        if ya1 > ya0 and xa1 > xa0:
            inside = img[ya0:ya1, xa0:xa1].to(torch.int64)
            if out_c == 1 and inside.shape[2] == 3:
                r, g, b = inside.unbind(-1)
                inside = ((r * GREY[0] + g * GREY[1] + b * GREY[2]
                           + (1 << 13)) >> 14)[..., None]
            crop[ya0 - y1:ya1 - y1, xa0 - x1:xa1 - x1] = inside
        xa, xb, wx = _taps(size - 1 - o if f else o, size, cw, device)
        ya, yb, wy = _taps(o, size, ch, device)
        wx, wy = wx[None, :, None], wy[:, None, None]
        h0, h1 = (r.index_select(1, xa) * (ONE - wx)
                  + r.index_select(1, xb) * wx
                  for r in (crop.index_select(0, ya), crop.index_select(0, yb)))
        v = h0 * (ONE - wy) + h1 * wy
        out[k] = ((v + (1 << 21)) >> 22).to(torch.uint8)
    return out


def normalize(frames: torch.Tensor) -> torch.Tensor:
    """ToTensor + ImageNet Normalize of uint8 (..., 3) RGB frames on their
    device, in float32 as ``egot2x/data/lam.py::normalize_frames`` computes
    it."""
    mean, std, full = (torch.tensor(v, dtype=torch.float32,
                                    device=frames.device)
                       for v in (IMAGENET_MEAN, IMAGENET_STD, 255.0))
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, one rounding off numpy's quotient
    return (frames.to(torch.float32) / full - mean) / std

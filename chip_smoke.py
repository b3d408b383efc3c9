#!/usr/bin/env python3
"""The quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each printing one line or more:

  1. device   the card's name and power limit (nvidia-smi) and torch's name;
  2. build    nvcc of the kernels' sources, one process per source, all
              started together (time; registers, spills and shared memory
              of every kernel);
  3. kernel   each stem kernel against its plain PyTorch version on the card
              at the main paths' shapes: the float stems (f32, bf16) and the
              int8 stems (2D with 1 and 2 trunks stacked, 3D; f32 and bf16
              input), with its time beside the plain version's, a library
              yardstick's and the card's bound for the same work, and its
              ``design`` (mma.sync: 3xFP16 for f32 input, bf16 with the
              weights as bf16 hi + lo for bf16 input);
  4. int8conv the int8 conv (im2col + ``torch._int_mm``) against its exact
              plain version at a layer1 and a layer4 shape, bit for bit;
     flash    the flash-attention kernel (mma.sync: bf16, or 3xTF32 for f32)
              against its plain version at TalkNet's shapes on a 2048-frame
              track ((8, 2048, 16) and (8, 2048, 32)) and the JAX oracle's
              odd (2, 257, 40) over 130 keys, f32 and bf16, with its time
              beside the plain version's, ``scaled_dot_product_attention``'s
              and the card's bound;
  5. slice    the float flagship ``TaskFusionMFTransformer3Task`` at the
              released widths (hidden 128, 1 layer, 4 heads, FFN 2048;
              ResNet-18 at 224^2, TalkNet at 112^2, f32) built by
              ``build_model``, random weights from a numpy seed in the JAX
              layout loaded through the weight bridge, answering requests of
              16 clips x 30 frames with an f32 and a uint8 feed; the stem
              launch counts must show every stem went through the kernel,
              the logits must be finite, the feeds must agree, and clip 0
              must match the port's CPU forward;
  6. int8     the same flagship at the bench configuration (``quant=True``,
              ``fuse_stems=True``, bf16 compute) with the same weights,
              calibrated on the first request by the port's ``calibrate``,
              answering the same requests; the launch counts must show one
              fused int8 RGB stem, one int8 TalkNet stem and 57 int8 convs
              per forward; its logits must agree with the float path's
              (cosine > 0.99), with the port's int8 CPU forward on clip 0
              and across the feeds;
  7. asd      ``TalkNetWithHeads`` (Stage-I ASD) with seeded weights through
              the bridge, answering an eval bucket (16 tracks x 150 frames)
              and one whole track of 2048 frames; per forward one TalkNet
              stem launch, and three flash launches on the track, none on
              the bucket; track 0 of the bucket must match the port's CPU
              forward, the whole track the same model with its attention
              computed by the plain version (logits and ``eval_step``);
  8. asd2     the Stage-II ASD translator ``TaskFusionMFTransformer3TaskASD``
              behind the lossAV head at its defaults (hidden 128, 1 layer,
              4 heads) on a bucket of 16 tracks x 150 frames with RGB at
              224^2; per forward two RGB stems and one TalkNet stem; track
              0 must match the port's CPU forward;
  9. train    frozen Stage-II training of the same flagship through the
              port's ``TalkingToMe2Loader`` (seeded weights from
              ``build_state``, Adam, dropout 0.1), f32 with TF32 off: a
              warm-up and 3 timed steps of 16 clips x 30 frames, then one
              validation batch. The loss must stay finite, every
              translator parameter must move, every trunk parameter and BN
              statistic must stay bit for bit, each step must launch two
              RGB stems and one TalkNet stem (no flash); one step with
              dropout off on 2 clips must match the same step on the CPU
              (loss to 1e-4 relative, every gradient leaf at cosine
              >= 0.99999);
 10. train_int8  the same with the int8 frozen trunks (``quant_trunks``,
              bf16 compute), calibrated on the first batch as the Trainer
              does: per step two int8 RGB stems (training never fuses
              them), one int8 TalkNet stem and 57 int8 convs; card vs CPU
              at the int8 bars (loss 1e-2 relative, cosine >= 0.99).

Then one JSON line of every kernel, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line. Float32 runs in full f32 throughout: TF32 is off for cuDNN and for
matmuls, so the card and the CPU compute the same function.

Bounds: the larger of the bytes (each input read once, each output
written once) at HBM bandwidth and the operations at the card's peak for
their type, f32 products counted at the TF32 tensor-core rate (one pass),
the least time the card could take; f32 rows also give the CUDA cores'
rate as ``bound_cuda_core_ms``.
"""

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
B, T, IMG, ASD_IMG = 16, 30, 224, 112   # one request: 16 clips of 30 frames
REQUESTS = 3
HIDDEN, LAYERS, HEADS = 128, 1, 4        # released flagship (bench.py)
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W). f32 products count
# at the TF32 tensor-core rate, one pass: the least time the card could
# take; the f32 CUDA cores' 67 TFLOP/s is reported beside it as
# bound_cuda_core_ms
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12, "int8": 1979e12}
F32_CUDA_CORE_FLOPS = 67e12
# kernel vs plain: f32 as tests/test_pallas_stem.py holds the Pallas kernel;
# bf16 output is one rounding of the f32 result (2^-8 relative)
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# int8 stem vs plain: one quantum anywhere, >= 99.9% equal (the f32 conv
# sums in another order, so a value at a rounding boundary can flip)
INT8_SHARE_EQUAL = 0.999
LOGIT_TOL = 1e-3   # card vs CPU, and uint8 vs f32 feed (rtol = atol)
# int8 bf16 path: the JAX package's bf16 int8 bar (tests/test_u8_input.py
# :122), scaled by the logits as LOGIT_TOL is; int8 vs float: its PTQ gate
# (tests/test_quant_gate.py:120); card vs CPU cosine
INT8_LOGIT_TOL = 5e-2
INT8_VS_FLOAT_COSINE = 0.99
INT8_CARD_CPU_COSINE = 0.999
CONVS_PER_FORWARD = 57   # 19 in each ResNet-18, 19 in the AVSR ResNet
SOURCES = ("stem_pool", "flash_attention")   # egot2x_torch/csrc/<name>.cu
# flash kernel shapes (name, BH, N, S, D): TalkNet's attention on one track
# of 2048 frames (8 heads; cross A<->V d 128, self-AV d 256) and the JAX
# oracle's odd shape (tests/test_pallas_attention.py)
FLASH_SHAPES = [("cross", 8, 2048, 2048, 16), ("self_av", 8, 2048, 2048, 32),
                ("oracle", 2, 257, 130, 40),
                ("wide", 2, 2048, 2048, 256)]   # D > 128: the chunked body
FLASH_PER_FORWARD = {"cross": 2, "self_av": 1}   # launches on the track
FLASH_ITERS = 50   # launches a graph replays to time a row
# kernel vs plain: f32 as tests/test_pallas_attention.py:27 holds the Pallas
# kernel; bf16 output is one rounding of the f32 result
FLASH_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-2)}  # rtol, atol
# exponentials: 16 per clock per SM (MUFU, H100 data sheet) x 132 SMs x the
# 1.98 GHz boost clock, reckoned, not measured
MUFU_EXP_PER_S = 16 * 132 * 1.98e9
ASD_TRACKS, ASD_FRAMES = 16, 150   # run_asd's eval bucket at the 150 base
ASD_LONG = 2048                    # one whole track: the flash threshold
ASD_REPEATS = 2                    # timed forwards per request
TRAIN_STEPS = 3                    # timed train steps after a warm-up
TRAIN_CHECK_CLIPS = 2              # the card vs CPU step
TTM_CLASS_WEIGHTS = [0.266, 0.734]
# card vs CPU train step: f32 (TF32 off) and the int8 bars of ROADMAP.md
# §3 item 3 (the JAX package's full-translator int8 gate: cosine > 0.99)
TRAIN_LOSS_RTOL = {False: 1e-4, True: 1e-2}
TRAIN_GRAD_COSINE = {False: 0.99999, True: 0.99}


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name, **fields):
    print(f"{name}: " + json.dumps(fields), flush=True)


def time_ms(fn, iters=10):
    """Mean device time of ``fn`` over ``iters`` calls, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed: for launches shorter than their host-side cost
    (a Python wrapper, ctypes), back-to-back calls time the host, not the
    card."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_phase():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("device", nvidia_smi=smi, torch_name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)
    return smi


def _kernel_label(mangled):
    """'stem_pool_tc_kernel<f32->int8,2d,n2>',
    'flash_attention_kernel<f32,d16>' or 'flash_attention_wide_kernel<f32>'
    from a mangled instance name."""
    import re

    m = re.search(r"flash_attention_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                  mangled)
    if m:
        dtype, dp = m.groups()
        return (f"flash_attention_kernel<{'f32' if dtype == 'f' else 'bf16'},"
                f"d{dp}>")
    m = re.search(r"flash_attention_wide_kernelI(f|13__nv_bfloat16)E", mangled)
    if m:
        return (f"flash_attention_wide_kernel<"
                f"{'f32' if m.group(1) == 'f' else 'bf16'}>")
    m = re.search(r"stem_pool_tc_kernelILi(\d+)ELi\d+ELi(\d+)ELb([01])E"
                  r"(f|13__nv_bfloat16|a)E", mangled)
    if not m:
        return mangled
    kt, ng, f32_in, out = m.groups()
    out = {"f": "f32", "a": "int8"}.get(out, "bf16")
    return (f"stem_pool_tc_kernel<{'f32' if f32_in == '1' else 'bf16'}->"
            f"{out},{'2d' if kt == '1' else '3d'},n{ng}>")


def _ptxas_report(log):
    """{kernel instance: (registers, spill store bytes)} from -Xptxas -v."""
    import re

    out, name, spills = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[_kernel_label(name)] = (int(m.group(1)), spills)
            name, spills = None, 0
    return out


def build_phase():
    """Every kernel source built at once, one nvcc each."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from egot2x_torch.ops import build, flash, stem

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(build.build, SOURCES))
    wall = time.perf_counter() - t0
    smem = {"stem_pool": stem.kernel_smem_bytes(),
            "flash_attention": {
                f"{name}_d{d}": flash.kernel_smem_bytes(d, dtype)
                for name, dtype in (("f32", torch.float32),
                                    ("bf16", torch.bfloat16))
                for d in (16, 32, 40, 64, 128, 256)}}
    for b in built:
        report = _ptxas_report(b.log)
        phase("build", source=f"egot2x_torch/csrc/{b.name}.cu",
              seconds=round(b.seconds, 3),
              registers={k: r for k, (r, _) in report.items()},
              spill_store_bytes={k: s for k, (_, s) in report.items()},
              smem_bytes=smem[b.name])
        if not report:
            fail(f"no kernel in the ptxas report of {b.name}.cu")
    phase("build", sources=len(built), wall_seconds=round(wall, 3))


def _stem_frames(kind, dtype):
    """Main-path input of one stem, on the card in ``dtype``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    if kind == "2d":
        x = rng.standard_normal((B * T, IMG, IMG, 3), dtype=np.float32)
    else:
        x = rng.uniform(-2.5, 3.5, (B, T, ASD_IMG, ASD_IMG)).astype(np.float32)
    return torch.from_numpy(x).cuda().to(getattr(torch, dtype))


def _stem_params(kind, trunks=1):
    """(weight, scale, bias) of ``trunks`` stems stacked on the output
    channels, drawn from the seed, on the card."""
    import numpy as np
    import torch

    from egot2x_torch.ops import stem

    rng = np.random.default_rng(SEED + 1)
    wshape, fan_in = (((64, 3, 7, 7), 147) if kind == "2d"
                      else ((64, 1, 5, 7, 7), 245))
    parts = []
    for _ in range(trunks):
        w = (rng.standard_normal(wshape) / np.sqrt(fan_in)).astype(np.float32)
        bn = [rng.uniform(0.8, 1.2, 64), rng.standard_normal(64) * 0.05,
              rng.standard_normal(64) * 0.05, rng.uniform(0.8, 1.2, 64)]
        parts.append((torch.from_numpy(w),) + stem.fold_bn(
            *(torch.tensor(v) for v in bn), 1e-5 if kind == "2d" else 1e-3))
    return [torch.cat(p).float().cuda() for p in zip(*parts)]


# how each kernel computes, by input type
STEM_F32 = ("mma.sync m16n8k16 3xFP16: x and w scaled by powers of two, "
            "fp16 hi + lo, 3 passes")
STEM_BF16 = "mma.sync m16n8k16 bf16, weights as bf16 hi + lo (2 passes)"
DESIGNS = {
    ("stem_pool", "float32"): STEM_F32,
    ("stem_pool", "bfloat16"): STEM_BF16,
    ("stem_pool_q", "float32"): STEM_F32,
    ("stem_pool_q", "bfloat16"): STEM_BF16,
    ("flash_attention", "float32"): "mma.sync m16n8k8 3xTF32",
    ("flash_attention", "bfloat16"): "mma.sync m16n8k16 bf16",
}


def _design(kernel, dtype, flops):
    """The kernel's ``design``, and for f32 input the operations' time at
    the f32 CUDA cores' rate (the bound before the tensor cores)."""
    out = {"design": DESIGNS[kernel, dtype]}
    if dtype == "float32":
        out["bound_cuda_core_ms"] = flops / F32_CUDA_CORE_FLOPS * 1e3
    return out


def _in_image_taps(n, k, stride, pad):
    """Taps of a k-wide window that land inside an axis of length n, summed
    over the conv's output positions along that axis."""
    n_out = (n + 2 * pad - k) // stride + 1
    return sum(sum(0 <= o * stride - pad + j < n for j in range(k))
               for o in range(n_out))


def _roofline(flops, nbytes, dtype):
    """(bound ms, what bounds it): ``flops`` over the peak of ``dtype`` or
    ``nbytes`` over HBM bandwidth, whichever is larger."""
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[1]]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _bound(kind, x, out):
    """Least time of the same work on the card: the conv's multiply-adds
    on in-image taps only (a tap in the zero padding needs no product;
    the BN, ReLU, quantize and pool epilogue, about 1%, is left out, so
    this stays a lower bound) for every output channel (64 per trunk)
    over the peak of the input type, or input + output bytes over HBM
    bandwidth, whichever is larger."""
    if kind == "2d":
        n, h, w, c_in = x.shape
        taps = (n * c_in * _in_image_taps(h, 7, 2, 3)
                * _in_image_taps(w, 7, 2, 3))
    else:   # per-sample temporal pad of 2: the taps of each clip alone
        b, t, h, w = x.shape
        taps = (b * _in_image_taps(t, 5, 1, 2) * _in_image_taps(h, 7, 2, 3)
                * _in_image_taps(w, 7, 2, 3))
    flops = 2.0 * taps * out.shape[-1]
    nbytes = x.numel() * x.element_size() + out.numel() * out.element_size()
    return _roofline(flops, nbytes, x.dtype) + (flops, nbytes)


def _library_call(kind, x, w, scale, bias, steps=None):
    """One cuDNN conv in the input's dtype with the BN folded into weight
    and bias, then ReLU and max-pool (and, with ``steps``, the int8
    quantize, after the pool: the same values, since max commutes with
    the quantizer): the yardstick, used nowhere in the port."""
    import torch
    import torch.nn.functional as F

    wf = (w * scale.view(-1, *([1] * (w.dim() - 1)))).to(x.dtype)
    b = bias.to(x.dtype)
    if kind == "2d":
        xin = x.permute(0, 3, 1, 2)          # channels_last view
        wf = wf.contiguous(memory_format=torch.channels_last)
        run = lambda: F.max_pool2d(
            torch.relu_(F.conv2d(xin, wf, b, 2, 3)), 3, 2, 1)
    else:
        xin = x.unsqueeze(1)
        run = lambda: F.max_pool3d(
            torch.relu_(F.conv3d(xin, wf, b, (1, 2, 2), (2, 3, 3))),
            (1, 3, 3), (1, 2, 2), (0, 1, 1))
    if steps is None:
        return run
    s = steps.repeat_interleave(64).view(-1, *([1] * (2 if kind == "2d"
                                                      else 3)))
    return lambda: torch.clamp(torch.round(run().float() / s), 0, 127).to(
        torch.int8)


def kernel_phase():
    """Each float stem kernel vs its plain version, f32 and bf16; returns
    the numbers per (kernel, dtype)."""
    import torch

    from egot2x_torch.ops import stem

    fns = {"2d": (stem.stem_pool_2d, stem.stem_pool_2d_plain),
           "3d": (stem.stem_pool_3d, stem.stem_pool_3d_plain)}
    results = {}
    for kind, (kernel, plain) in fns.items():
        w, scale, bias = _stem_params(kind)
        for dtype in ("float32", "bfloat16"):
            x = _stem_frames(kind, dtype)
            out = kernel(x, w, scale, bias)
            torch.cuda.synchronize()
            ref = plain(x.float(), w, scale, bias)
            tol = KERNEL_TOL[dtype]
            err = (out.float() - ref).abs()
            ok = bool((err <= tol + tol * ref.abs()).all())
            row = dict(
                kernel=f"stem_pool_{kind}", dtype=dtype, shape=list(x.shape),
                out_shape=list(out.shape), max_abs_err=float(err.max()),
                tol=tol, ok=ok, ms=time_ms(lambda: kernel(x, w, scale, bias)),
                plain_ms=time_ms(lambda: plain(x, w, scale, bias)),
                library_ms=time_ms(_library_call(kind, x, w, scale, bias)))
            (row["bound_ms"], row["bound_by"], row["flops"],
             row["bytes"]) = _bound(kind, x, out)
            row.update(_design("stem_pool", dtype, row["flops"]))
            phase("kernel", **row)
            if not ok:
                fail(f"stem_pool_{kind} {dtype} disagrees with its plain "
                     f"version: max abs err {row['max_abs_err']}")
            results[row["kernel"], dtype] = row
            del x, out, ref, err
            torch.cuda.empty_cache()
    return results


def kernel_q_phase():
    """Each int8 stem kernel vs its plain version: 2D with 1 and 2 trunks
    stacked and 3D, f32 and bf16 input. Each trunk's step is calibrated
    as ``calibrate`` would: from the max of its float stem's output.
    Returns the numbers per (kernel, dtype); the 2D row is the stacked one
    (n = 2), the main path's."""
    import torch

    from egot2x_torch.ops import stem

    cases = [("2d", 1, stem.stem_pool_q_2d, stem.stem_pool_q_2d_plain),
             ("2d", 2, stem.stem_pool_q_2d, stem.stem_pool_q_2d_plain),
             ("3d", 1, stem.stem_pool_q_3d, stem.stem_pool_q_3d_plain)]
    results = {}
    for kind, n, kernel, plain in cases:
        w, scale, bias = _stem_params(kind, n)
        float_stem = stem.stem_pool_2d if kind == "2d" else stem.stem_pool_3d
        x32 = _stem_frames(kind, "float32")
        steps = torch.stack([
            float_stem(x32, w[64 * i:64 * (i + 1)], scale[64 * i:64 * (i + 1)],
                       bias[64 * i:64 * (i + 1)]).max()
            for i in range(n)]).clamp(min=1e-6) / 127.0
        del x32
        for dtype in ("float32", "bfloat16"):
            x = _stem_frames(kind, dtype)
            out = kernel(x, w, scale, bias, steps)
            torch.cuda.synchronize()
            ref = plain(x, w, scale, bias, steps)
            diff = (out.int() - ref.int()).abs()
            share = float((diff == 0).double().mean())
            row = dict(
                kernel=f"stem_pool_q_{kind}", trunks=n, dtype=dtype,
                shape=list(x.shape), out_shape=list(out.shape),
                max_abs_err=int(diff.max()), share_equal=share,
                nonzero_share=float((ref != 0).double().mean()),
                ms=time_ms(lambda: kernel(x, w, scale, bias, steps)),
                plain_ms=time_ms(lambda: plain(x, w, scale, bias, steps)),
                library_ms=time_ms(_library_call(kind, x, w, scale, bias,
                                                 steps)))
            (row["bound_ms"], row["bound_by"], row["flops"],
             row["bytes"]) = _bound(kind, x, out)
            row.update(_design("stem_pool_q", dtype, row["flops"]))
            phase("kernel_q", **row)
            if row["max_abs_err"] > 1 or share < INT8_SHARE_EQUAL:
                fail(f"stem_pool_q_{kind} n={n} {dtype} disagrees with its "
                     f"plain version: max |diff| {row['max_abs_err']}, "
                     f"{share:.6f} equal")
            if n == 2 or kind == "3d":
                results[row["kernel"], dtype] = row
            del x, out, ref, diff
            torch.cuda.empty_cache()
    return results


def int8_conv_phase():
    """The int8 conv (NHWC im2col + ``torch._int_mm``) against its exact
    plain version (a float64 conv of the int8 values) at a layer1 and a
    layer4 shape of the main path: int32, bit for bit. Returns the layer1
    row (the largest im2col)."""
    import torch

    from egot2x_torch.ops import int8

    g = torch.Generator().manual_seed(SEED)
    cases = {"layer1.0.conv1": (B * T, 64, 56, 64, 3, 1),
             "layer4.0.conv1": (B * T, 256, 14, 512, 3, 2)}
    rows = {}
    for name, (n, c, hw, o, k, stride) in cases.items():
        x = torch.randint(-127, 128, (n, c, hw, hw), dtype=torch.int8,
                          generator=g).cuda()
        x = x.contiguous(memory_format=torch.channels_last)
        w = torch.randint(-127, 128, (o, c, k, k), dtype=torch.int8,
                          generator=g).cuda()
        got = int8.conv2d_int8(x, w, stride, k // 2)
        want = int8.conv2d_int8_plain(x, w, stride, k // 2)
        exact = torch.equal(got, want)
        ho = got.shape[2]
        flops = 2.0 * n * ho * ho * o * c * k * k
        nbytes = x.numel() + w.numel() + got.numel() * 4
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        row = dict(conv=name, shape=list(x.shape), weight=list(w.shape),
                   out_shape=list(got.shape), exact=exact,
                   max_abs_err=int((got - want).abs().max()),
                   ms=time_ms(lambda: int8.conv2d_int8(x, w, stride, k // 2)),
                   peak_extra_gib=(torch.cuda.max_memory_allocated()
                                   - before) / 2**30,
                   plain_ms=time_ms(lambda: int8.conv2d_int8_plain(
                       x, w, stride, k // 2), iters=3),
                   library_ms=None, flops=flops, bytes=nbytes)
        row["bound_ms"], row["bound_by"] = _roofline(flops, nbytes, x.dtype)
        phase("int8conv", **row)
        if not exact:
            fail(f"int8 conv {name} differs from its exact plain version")
        rows[name] = row
        del x, w, got, want
        torch.cuda.empty_cache()
    return rows["layer1.0.conv1"]


def _flash_bound(q, k, out):
    """Least time of one flash launch on the card: the larger of its
    FLOPs (4 BH N S D: Q K^T and P V) at the peak of the input type, its
    BH N S exponentials at the reckoned MUFU rate, and its bytes (q, k, v
    read once, the output written once) at HBM bandwidth. Returns (bound
    ms, "bytes" or "operations", which of the three, flops, exps, bytes)."""
    bh, n, d = q.shape
    s = k.shape[1]
    flops = 4.0 * bh * n * s * d
    exps = float(bh * n * s)
    nbytes = (q.numel() + 2 * k.numel() + out.numel()) * q.element_size()
    times = {"flops": flops / PEAK_FLOPS[str(q.dtype).split(".")[1]],
             "exps": exps / MUFU_EXP_PER_S, "bytes": nbytes / HBM_BYTES_PER_S}
    which = max(times, key=times.get)
    return (times[which] * 1e3, "bytes" if which == "bytes" else "operations",
            which, flops, exps, nbytes)


def flash_phase():
    """The flash kernel vs its plain version, f32 and bf16, at TalkNet's
    track shapes, the JAX oracle's odd shape and a head dim of 256 (the
    body for D > 128, which no path runs yet); returns the rows per
    (shape name, dtype). The yardstick is ``scaled_dot_product_attention``
    on (1, BH, N, D) views: its fused backends take 4-D input only. All
    three are timed by graph replay (``graph_ms``): a launch takes tens of
    microseconds, no more than the wrapper's host-side cost."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from egot2x_torch.ops import flash

    rows = {}
    for name, bh, n, s, d in FLASH_SHAPES:
        rng = np.random.default_rng(SEED + d)
        host = [rng.standard_normal((bh, m, d)).astype(np.float32)
                for m in (n, s, s)]
        for dtype in ("float32", "bfloat16"):
            q, k, v = (torch.from_numpy(x).cuda().to(getattr(torch, dtype))
                       for x in host)
            out = flash.flash_attention(q, k, v)
            torch.cuda.synchronize()
            ref = flash.flash_attention_plain(q, k, v).float()
            rtol, atol = FLASH_TOL[dtype]
            err = (out.float() - ref).abs()
            ok = bool((err <= atol + rtol * ref.abs()).all())
            row = dict(
                kernel="flash_attention", shape_name=name, dtype=dtype,
                q=list(q.shape), k=list(k.shape), max_abs_err=float(err.max()),
                rtol=rtol, atol=atol, ok=ok,
                ms=graph_ms(lambda: flash.flash_attention(q, k, v),
                            FLASH_ITERS),
                plain_ms=graph_ms(lambda: flash.flash_attention_plain(q, k, v),
                                  FLASH_ITERS),
                library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                    *(x.unsqueeze(0) for x in (q, k, v))), FLASH_ITERS))
            (row["bound_ms"], row["bound_by"], row["bound_detail"],
             row["flops"], row["exps"], row["bytes"]) = _flash_bound(q, k, out)
            row.update(_design("flash_attention", dtype, row["flops"]))
            phase("flash", **row)
            if not ok:
                fail(f"flash_attention {name} {dtype} disagrees with its "
                     f"plain version: max abs err {row['max_abs_err']}")
            rows[name, dtype] = row
            del q, k, v, out, ref, err
    torch.cuda.empty_cache()
    return rows


def _flash_line_row(rows, counts):
    """The kernels-line row of the flash kernel: each time the mean per
    launch over one forward's launches on the main path (f32, two cross
    launches at D 16, one self-AV launch at D 32)."""
    mix = [(rows[name, "float32"], w) for name, w in FLASH_PER_FORWARD.items()]
    total = sum(w for _, w in mix)
    mean = lambda key: sum(r[key] * w for r, w in mix) / total
    # what bounds the launch that weighs most in the mean bound
    bound_by = max(mix, key=lambda rw: rw[0]["bound_ms"] * rw[1])[0]["bound_by"]
    return dict(name="flash_attention", route="cuda",
                source="egot2x_torch/csrc/flash_attention.cu",
                replaces="egot2x/ops/pallas_attention.py:77", dtype="float32",
                design=DESIGNS["flash_attention", "float32"],
                shapes="mean per launch of one 2048-frame TalkNet forward: "
                       "2 x (8, 2048, 16), 1 x (8, 2048, 32)",
                launches=counts["flash_attention"],
                max_abs_err=max(r["max_abs_err"] for r, _ in mix),
                ms=mean("ms"), plain_ms=mean("plain_ms"),
                bound_ms=mean("bound_ms"), bound_by=bound_by,
                library_ms=mean("library_ms"))


def _requests():
    import numpy as np

    from egot2x_torch.data.lam import normalize_frames

    rng = np.random.default_rng(SEED + 1)
    for _ in range(REQUESTS):
        rgb = rng.integers(0, 256, (B, T, IMG, IMG, 3), dtype=np.uint8)
        grey = rng.integers(0, 256, (B, T, ASD_IMG, ASD_IMG), dtype=np.uint8)
        mfcc = rng.standard_normal((B, 4 * T, 13), dtype=np.float32)
        yield dict(u8=(rgb, grey), f32=(normalize_frames(rgb),
                                        grey.astype(np.float32)), mfcc=mfcc)


def _counters():
    """Every kernel wrapper of the port, by name."""
    from egot2x_torch.ops import flash, int8, stem

    return {"stem_pool_2d": stem.stem_pool_2d,
            "stem_pool_3d": stem.stem_pool_3d,
            "stem_pool_q_2d": stem.stem_pool_q_2d,
            "stem_pool_q_3d": stem.stem_pool_q_3d,
            "int8_conv2d": int8.conv2d_int8,
            "flash_attention": flash.flash_attention}


def _build_flagship(**kw):
    """The released flagship (``kw`` adds the int8 configuration) with the
    seeded weights, on the card. A quant model draws the float model's
    weights: its scales are 0 until calibrated."""
    from egot2x_torch.core import bridge
    from egot2x_torch.core.registry import build_model

    kw = dict(hidden_dim=HIDDEN, num_heads=HEADS, num_layers=LAYERS, **kw)
    model = build_model("TaskFusionMFTransformer3Task", **kw)
    bridge.load_jax_variables(model, bridge.random_jax_variables(model, SEED))
    return model, kw


def _serve(model, requests):
    """The main path: a warm-up, the timed requests (f32 feed) and one
    uint8-feed request, with every launch count set to 0 just before and
    read just after. Returns (logits, uint8 logits, seconds of the timed
    requests, peak GiB, launch counts)."""
    import torch

    on_card = [dict(f32=[torch.from_numpy(a).cuda() for a in r["f32"]],
                    u8=[torch.from_numpy(a).cuda() for a in r["u8"]],
                    mfcc=torch.from_numpy(r["mfcc"]).cuda())
               for r in requests]
    audio = torch.zeros(B, T * 16000 // 30).cuda()  # unused stream

    def forward(req, feed):
        video, grey = req[feed]
        return model(video, grey, audio, req["mfcc"])

    for fn in _counters().values():
        fn.launches = 0
    with torch.no_grad():
        forward(on_card[0], "f32")                      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits = [forward(req, "f32") for req in on_card]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        u8_logits = forward(on_card[0], "u8")
        torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in _counters().items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for out in logits + [u8_logits]:
        if out.shape != (B, 2) or not bool(torch.isfinite(out).all()):
            fail(f"logits of shape {tuple(out.shape)}, finite "
                 f"{bool(torch.isfinite(out).all())}")
    return logits, u8_logits, seconds, peak_gib, counts


def _cpu_clip0(kw, model, request):
    """Logits of clip 0 through the port on the CPU (plain versions), with
    the card model's state (weights and scales)."""
    import torch

    from egot2x_torch.core.registry import build_model

    cpu = build_model("TaskFusionMFTransformer3Task", device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        return cpu(torch.from_numpy(request["f32"][0][:1]),
                   torch.from_numpy(request["f32"][1][:1]), None,
                   torch.from_numpy(request["mfcc"][:1]))[0].float()


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def _expected(forwards, **per_forward):
    return {name: per_forward.get(name, 0) * forwards for name in _counters()}


def slice_phase(card, requests):
    """The float flagship on the card; returns (launch counts, logits of
    request 0)."""
    import numpy as np
    import torch

    model, kw = _build_flagship()
    logits, u8_logits, seconds, peak_gib, counts = _serve(model, requests)
    expect = _expected(REQUESTS + 2, stem_pool_2d=2, stem_pool_3d=1)
    phase("slice", card=card, model="TaskFusionMFTransformer3Task",
          hidden=HIDDEN, layers=LAYERS, heads=HEADS, clips=B, frames=T,
          requests=REQUESTS, clips_per_s=REQUESTS * B / seconds,
          ms_per_request=seconds / REQUESTS * 1e3, peak_mem_gib=peak_gib,
          launches=counts, expected_launches=expect)
    if counts != expect:
        fail(f"launches {counts}, expected {expect}")
    feed_err = float((u8_logits - logits[0]).abs().max())
    want = _cpu_clip0(kw, model, requests[0])
    got = logits[0][0].cpu()
    cpu_err = float((got - want).abs().max())
    phase("check", logits_clip0_card=got.tolist(),
          logits_clip0_cpu=want.tolist(), max_abs_err_cpu=cpu_err,
          max_abs_err_u8_vs_f32_feed=feed_err, tol=LOGIT_TOL,
          logit_abs_max=float(torch.cat(logits).abs().max()))
    scale = 1.0 + float(want.abs().max())
    if not np.isfinite(cpu_err) or cpu_err > LOGIT_TOL * scale:
        fail(f"card logits differ from the CPU's by {cpu_err}")
    if feed_err > LOGIT_TOL * scale:
        fail(f"uint8 feed differs from the f32 feed by {feed_err}")
    return counts, logits[0].float()


def int8_slice_phase(card, requests, float_logits):
    """The flagship at the bench configuration (int8 trunks, fused LAM +
    TTM stem, bf16 compute), the float slice's weights, calibrated on the
    first request as bench.py does; returns the launch counts."""
    import numpy as np
    import torch

    from egot2x_torch.nn.quant import calibrate

    model, kw = _build_flagship(quant=True, fuse_stems=True,
                                dtype=torch.bfloat16)
    r0 = requests[0]
    t0 = time.perf_counter()
    calibrate(model, *(torch.from_numpy(a).cuda() for a in r0["f32"]), None,
              torch.from_numpy(r0["mfcc"]).cuda())
    torch.cuda.synchronize()
    calibrate_s = time.perf_counter() - t0
    logits, u8_logits, seconds, peak_gib, counts = _serve(model, requests)
    expect = _expected(REQUESTS + 2, stem_pool_q_2d=1, stem_pool_q_3d=1,
                       int8_conv2d=CONVS_PER_FORWARD)
    phase("int8", card=card, model="TaskFusionMFTransformer3Task",
          quant=True, fuse_stems=True, dtype="bfloat16", hidden=HIDDEN,
          layers=LAYERS, heads=HEADS, clips=B, frames=T, requests=REQUESTS,
          clips_per_s=REQUESTS * B / seconds,
          ms_per_request=seconds / REQUESTS * 1e3, peak_mem_gib=peak_gib,
          calibrate_s=calibrate_s, launches=counts, expected_launches=expect,
          window="smoke: 3 timed requests of 16 clips x 30 frames, not the "
                 "bench batch of 160")
    if counts != expect:
        fail(f"launches {counts}, expected {expect}")
    vs_float = _cosine(logits[0].float(), float_logits)
    feed_err = float((u8_logits.float() - logits[0].float()).abs().max())
    want = _cpu_clip0(kw, model, r0)
    got = logits[0][0].float().cpu()
    cpu_err = float((got - want).abs().max())
    cpu_cos = _cosine(got, want)
    scale = 1.0 + float(want.abs().max())
    phase("int8_check", logits_clip0_card=got.tolist(),
          logits_clip0_cpu=want.tolist(), max_abs_err_cpu=cpu_err,
          cosine_cpu=cpu_cos, max_abs_err_u8_vs_f32_feed=feed_err,
          cosine_vs_float=vs_float, tol=INT8_LOGIT_TOL,
          logit_abs_max=float(torch.cat(logits).float().abs().max()))
    if vs_float <= INT8_VS_FLOAT_COSINE:
        fail(f"int8 logits vs float: cosine {vs_float}")
    if (not np.isfinite(cpu_err) or cpu_err > INT8_LOGIT_TOL * scale
            or cpu_cos <= INT8_CARD_CPU_COSINE):
        fail(f"int8 card logits differ from the CPU's by {cpu_err} "
             f"(cosine {cpu_cos})")
    if feed_err > INT8_LOGIT_TOL * scale:
        fail(f"int8: uint8 feed differs from the f32 feed by {feed_err}")
    return counts


def _asd_batch(tracks, frames, seed):
    """An ASD request on the card: grey faces in [0, 255] (f32), MFCC at
    4 rows per frame, frame labels."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    faces = rng.integers(0, 256, (tracks, frames, ASD_IMG, ASD_IMG),
                         dtype=np.uint8)
    return dict(
        faces=torch.from_numpy(faces).cuda().float(),
        mfcc=torch.from_numpy(rng.standard_normal(
            (tracks, 4 * frames, 13), dtype=np.float32)).cuda(),
        labels=torch.from_numpy(rng.integers(0, 2, (tracks, frames))).cuda())


def _serve_requests(forward):
    """A main path: every launch count set to 0, a warm-up and
    ``ASD_REPEATS`` timed forwards, the counts read. Returns (output of
    the last forward, ms per request, peak GiB, launch counts, forwards)."""
    import torch

    for fn in _counters().values():
        fn.launches = 0
    with torch.no_grad():
        forward()                                        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(ASD_REPEATS):
            out = forward()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in _counters().items()}
    return (out, seconds / ASD_REPEATS * 1e3,
            torch.cuda.max_memory_allocated() / 2**30, counts,
            ASD_REPEATS + 1)


def _check_close(what, got, want):
    """max |got - want| <= LOGIT_TOL (1 + max |want|) for each head."""
    import numpy as np

    errs = {}
    for key in want:
        g, w = got[key].float().cpu(), want[key].float().cpu()
        errs[key] = float((g - w).abs().max())
        if (g.shape != w.shape or not np.isfinite(errs[key])
                or errs[key] > LOGIT_TOL * (1.0 + float(w.abs().max()))):
            fail(f"{what}: {key} differs by {errs[key]} "
                 f"(shapes {tuple(g.shape)}, {tuple(w.shape)})")
    return errs


def _check_finite(what, outs, shape):
    import torch

    for key, out in outs.items():
        if out.shape != shape or not bool(torch.isfinite(out).all()):
            fail(f"{what}: {key} of shape {tuple(out.shape)}, finite "
                 f"{bool(torch.isfinite(out).all())}")


@contextlib.contextmanager
def _plain_attention():
    """The flash route computing with the kernel's plain version, on the
    card (for the comparison only)."""
    from egot2x_torch.ops import flash

    kernel = flash.flash_attention
    flash.flash_attention = flash.flash_attention_plain
    try:
        yield
    finally:
        flash.flash_attention = kernel


def asd_phase(card):
    """Stage-I ASD (``TalkNetWithHeads``) on an eval bucket and on one
    whole 2048-frame track; returns the launch counts of the track's
    path."""
    import torch

    from egot2x_torch.core import bridge
    from egot2x_torch.core.registry import build_model
    from egot2x_torch.tasks.asd import ActiveSpeakerDetection

    model = build_model("TalkNetWithHeads")
    bridge.load_jax_variables(model, bridge.random_jax_variables(model, SEED))
    task = ActiveSpeakerDetection(model)
    requests = {"bucket": (_asd_batch(ASD_TRACKS, ASD_FRAMES, SEED + 2),
                           dict(stem_pool_3d=1)),
                "track": (_asd_batch(1, ASD_LONG, SEED + 3),
                          dict(stem_pool_3d=1, flash_attention=3))}
    counts = {}
    for name, (batch, per_forward) in requests.items():
        tracks, frames = batch["labels"].shape
        outs, ms, peak, counts[name], forwards = _serve_requests(
            lambda: model(batch["mfcc"], batch["faces"]))
        expect = _expected(forwards, **per_forward)
        phase("asd", card=card, model="TalkNetWithHeads", request=name,
              tracks=tracks, frames=frames, ms_per_request=ms,
              frames_per_s=tracks * frames / ms * 1e3, peak_mem_gib=peak,
              launches=counts[name], expected_launches=expect)
        if counts[name] != expect:
            fail(f"asd {name}: launches {counts[name]}, expected {expect}")
        _check_finite(f"asd {name}", outs, (tracks, frames, 2))
        if name == "bucket":
            cpu = build_model("TalkNetWithHeads", device="cpu")
            cpu.load_state_dict({k: v.cpu()
                                 for k, v in model.state_dict().items()})
            with torch.no_grad():
                want = cpu(batch["mfcc"][:1].cpu(), batch["faces"][:1].cpu())
            errs = _check_close("asd bucket track 0, card vs CPU",
                                {k: v[:1] for k, v in outs.items()}, want)
            phase("asd_check", request=name, vs="cpu, track 0",
                  max_abs_err=errs, tol=LOGIT_TOL)
        else:
            got_eval = task.eval_step(batch)
            with _plain_attention(), torch.no_grad():
                want = model(batch["mfcc"], batch["faces"])
                want_eval = task.eval_step(batch)
            errs = _check_close("asd track, flash vs plain attention", outs,
                                want)
            agree = all(torch.equal(got_eval[k], want_eval[k])
                        for k in ("correct", "total"))
            phase("asd_check", request=name, vs="plain attention on the card",
                  max_abs_err=errs, tol=LOGIT_TOL,
                  correct=int(got_eval["correct"].sum()),
                  total=int(got_eval["total"].sum()), eval_agrees=agree)
            if not agree:
                fail("asd track: eval_step differs under plain attention")
    return counts["track"]


def asd2_phase(card):
    """The Stage-II ASD translator behind the lossAV head at its defaults
    on a bucket of 16 tracks x 150 frames."""
    import numpy as np
    import torch

    from egot2x_torch.core import bridge
    from egot2x_torch.nn.resnet2d import normalize_u8_frames
    from egot2x_torch.tasks.asd_2loader import build_translator_with_head

    model = build_translator_with_head("TaskFusionMFTransformer3TaskASD")
    bridge.load_jax_variables(model, bridge.random_jax_variables(model, SEED))
    batch = _asd_batch(ASD_TRACKS, ASD_FRAMES, SEED + 4)
    rng = np.random.default_rng(SEED + 5)
    rgb = rng.integers(0, 256, (ASD_TRACKS, ASD_FRAMES, IMG, IMG, 3),
                       dtype=np.uint8)
    frames = normalize_u8_frames(torch.from_numpy(rgb).cuda())   # f32
    audio = torch.zeros(ASD_TRACKS, ASD_FRAMES * 16000 // 30).cuda()  # unused
    inputs = (frames, batch["faces"], audio, batch["mfcc"])
    out, ms, peak, counts, forwards = _serve_requests(lambda: model(*inputs))
    expect = _expected(forwards, stem_pool_2d=2, stem_pool_3d=1)
    core = model.translator
    phase("asd2", card=card, model="TaskFusionMFTransformer3TaskASD",
          head="lossAV", hidden=core.output_dim,
          layers=len(core.transformer_encoder.layers),
          heads=core.transformer_encoder.layers[0].self_attn.num_heads,
          tracks=ASD_TRACKS, frames=ASD_FRAMES, rgb=IMG, ms_per_request=ms,
          frames_per_s=ASD_TRACKS * ASD_FRAMES / ms * 1e3, peak_mem_gib=peak,
          launches=counts, expected_launches=expect)
    if counts != expect:
        fail(f"asd2: launches {counts}, expected {expect}")
    _check_finite("asd2", {"logits": out}, (ASD_TRACKS * ASD_FRAMES, 2))
    cpu = build_translator_with_head("TaskFusionMFTransformer3TaskASD",
                                     device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        want = cpu(*(x[:1].cpu() for x in inputs))
    errs = _check_close("asd2 track 0, card vs CPU",
                        {"logits": out[:ASD_FRAMES]}, {"logits": want})
    phase("asd2_check", vs="cpu, track 0", max_abs_err=errs, tol=LOGIT_TOL)


def _train_cfg(quant):
    from egot2x_torch.core.config import Config

    return Config(model="TaskFusionMFTransformer3Task",
                  weights=TTM_CLASS_WEIGHTS, lr=1e-4, wd=1e-4,
                  hidden_dim=HIDDEN, num_layers=LAYERS, num_heads=HEADS,
                  dropout=0.1, quant_trunks=quant,
                  compute_dtype="bf16" if quant else "float32")


def _train_batches(n, seed):
    """``n`` train batches of B clips x T frames drawn on the card: RGB
    normalized from uint8, grey faces in [0, 255], MFCC, labels, and the
    segment fields validation reads."""
    import torch

    from egot2x_torch.nn.resnet2d import normalize_u8_frames

    g = torch.Generator("cuda").manual_seed(seed)
    u8 = lambda *shape: torch.randint(0, 256, shape, generator=g,
                                      device="cuda", dtype=torch.uint8)
    return [dict(frames=normalize_u8_frames(u8(B, T, IMG, IMG, 3)),
                 video_asd=u8(B, T, ASD_IMG, ASD_IMG).float(),
                 audio=torch.zeros(B, T * 16000 // 30, device="cuda"),
                 audio_asd=torch.randn(B, 4 * T, 13, generator=g,
                                       device="cuda"),
                 label=torch.randint(0, 2, (B,), generator=g, device="cuda"),
                 seg_id=[f"seg{i}" for i in range(B)],
                 start=[0] * B, end=[T] * B)
            for _ in range(n)]


def _no_dropout(model):
    from egot2x_torch.nn.common import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0


def _train_check(task, state, batch, quant):
    """One train step with dropout off on the first clips of ``batch``, on
    the card and on the CPU from the card model's state (weights and int8
    scales): (loss relative error, least gradient cosine over the
    translator's leaves, that leaf)."""
    import torch

    from egot2x_torch.tasks.ttm_2loader import TalkingToMe2Loader

    small = {k: v[:TRAIN_CHECK_CLIPS] for k, v in batch.items()}
    cpu_task = TalkingToMe2Loader(_train_cfg(quant), device="cpu")
    cpu_state = cpu_task.build_state(SEED)
    cpu_task.model.load_state_dict(
        {k: v.cpu() for k, v in state.model.state_dict().items()})
    _no_dropout(state.model)
    _no_dropout(cpu_task.model)
    state, card = task.train_step(state, small, torch.Generator("cuda"))
    cpu_state, cpu = cpu_task.train_step(
        cpu_state, {k: v.cpu() for k, v in small.items()
                    if isinstance(v, torch.Tensor)}, torch.Generator())
    grads = {n: p.grad.cpu() for n, p in state.model.named_parameters()
             if p.grad is not None}
    cpu_grads = {n: p.grad for n, p in cpu_task.model.named_parameters()
                 if p.grad is not None}
    if sorted(grads) != sorted(cpu_grads):
        fail(f"train check: gradient leaves differ, {sorted(grads)} vs "
             f"{sorted(cpu_grads)}")
    cosines = {n: _cosine(grads[n], cpu_grads[n]) for n in grads}
    worst = min(cosines, key=cosines.get)
    want = float(cpu["loss"])
    return (abs(float(card["loss"]) - want) / abs(want), cosines[worst],
            worst, float(card["loss"]), want)


def train_phase(card, quant):
    """Frozen Stage-II training of the flagship through the port's task:
    a warm-up and TRAIN_STEPS timed steps with every launch count set to
    0 just before and read just after, one validation batch, the frozen
    trunks and the translator checked, then the card vs CPU step. Returns
    the launch counts."""
    import torch

    from egot2x_torch.tasks.ttm_2loader import TalkingToMe2Loader
    from egot2x_torch.translate.egot2s_hhi import FROZEN_KEYS

    name = "train_int8" if quant else "train"
    task = TalkingToMe2Loader(_train_cfg(quant))
    state = task.build_state(SEED)
    batches = _train_batches(TRAIN_STEPS + 1, SEED + 6)
    calibrate_s = None
    if quant:   # as the Trainer does: the scales are 0 after build_state
        t0 = time.perf_counter()
        task.calibrate_state(state, batches[0])
        torch.cuda.synchronize()
        calibrate_s = time.perf_counter() - t0
    model = state.model
    frozen = {k: v.clone() for k, v in model.state_dict().items()
              if k.split(".", 1)[0] in FROZEN_KEYS}
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    generator = torch.Generator("cuda").manual_seed(SEED + 7)
    for fn in _counters().values():
        fn.launches = 0
    state, metrics = task.train_step(state, batches[0], generator)  # warm-up
    losses = [metrics["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for batch in batches[1:]:
        state, metrics = task.train_step(state, batch, generator)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in _counters().items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    per_step = (dict(stem_pool_q_2d=2, stem_pool_q_3d=1,
                     int8_conv2d=CONVS_PER_FORWARD) if quant
                else dict(stem_pool_2d=2, stem_pool_3d=1))
    expect = _expected(TRAIN_STEPS + 1, **per_step)
    ctx = task.start_validation()
    task.accumulate(ctx, task.eval_step(state, batches[-1]), batches[-1])
    val = task.finalize_validation(ctx)
    losses = [float(x) for x in losses]
    moved = [n for n, p in model.named_parameters()
             if p.requires_grad and not torch.equal(p.detach(), before[n])]
    changed = [k for k, v in model.state_dict().items()
               if k in frozen and not torch.equal(v, frozen[k])]
    phase(name, card=card, model="TaskFusionMFTransformer3Task",
          task="TalkingToMe2Loader", quant_trunks=quant,
          dtype="bfloat16" if quant else "float32", hidden=HIDDEN,
          layers=LAYERS, heads=HEADS, clips=B, frames=T, steps=TRAIN_STEPS,
          clips_per_s=TRAIN_STEPS * B / seconds,
          ms_per_step=seconds / TRAIN_STEPS * 1e3, peak_mem_gib=peak_gib,
          calibrate_s=calibrate_s, losses=losses, validation=val,
          translator_leaves_moved=f"{len(moved)} of {len(before)}",
          frozen_entries_changed=len(changed), frozen_entries=len(frozen),
          launches=counts, expected_launches=expect)
    if counts != expect:
        fail(f"{name}: launches {counts}, expected {expect}")
    if not all(map(math.isfinite, losses)):
        fail(f"{name}: losses {losses}")
    if len(moved) != len(before):
        fail(f"{name}: translator leaves that did not move: "
             f"{sorted(set(before) - set(moved))[:5]}")
    if changed:
        fail(f"{name}: frozen entries changed: {changed[:5]}")
    if not all(0.0 <= v <= 1.0 for v in val.values()):
        fail(f"{name}: validation {val}")
    loss_err, cosine, leaf, card_loss, cpu_loss = _train_check(
        task, state, batches[0], quant)
    phase(f"{name}_check", vs="cpu", clips=TRAIN_CHECK_CLIPS, frames=T,
          dropout=0.0, loss_card=card_loss, loss_cpu=cpu_loss,
          loss_rel_err=loss_err, loss_rtol=TRAIN_LOSS_RTOL[quant],
          min_grad_cosine=cosine, min_grad_cosine_leaf=leaf,
          cosine_bar=TRAIN_GRAD_COSINE[quant])
    if not loss_err <= TRAIN_LOSS_RTOL[quant]:
        fail(f"{name}: card loss {card_loss} vs CPU {cpu_loss}")
    if not cosine >= TRAIN_GRAD_COSINE[quant]:
        fail(f"{name}: gradient of {leaf} at cosine {cosine} with the CPU's")
    return counts


def _line_row(name, row, counts, replaces, route="cuda",
              source="egot2x_torch/csrc/stem_pool.cu"):
    return dict(name=name, route=route, source=source, replaces=replaces,
                dtype=str(row.get("dtype", "int8")),
                design=row.get("design", "im2col + torch._int_mm"),
                launches=counts[name], max_abs_err=row["max_abs_err"],
                ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"])


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (ROOT / "egot2x_torch").is_dir():
        fail(f"no egot2x_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = device_phase()
    build_phase()
    kernels = {**kernel_phase(), **kernel_q_phase()}
    conv = int8_conv_phase()
    flash_rows = flash_phase()
    requests = list(_requests())
    float_counts, float_logits = slice_phase(card, requests)
    int8_counts = int8_slice_phase(card, requests, float_logits)
    del requests
    asd_counts = asd_phase(card)
    asd2_phase(card)
    train_counts = {"train": train_phase(card, quant=False),
                    "train_int8": train_phase(card, quant=True)}
    float_stem, int8_stem = ("egot2x/ops/pallas_stem.py:232",
                             "egot2x/ops/pallas_stem.py:351")
    # each kernel at its main path's input type: f32 (float slice), bf16
    # (int8 slice)
    line = [_line_row(f"stem_pool_{k}", kernels[f"stem_pool_{k}", "float32"],
                      float_counts, float_stem) for k in ("2d", "3d")]
    line += [_line_row(f"stem_pool_q_{k}",
                       kernels[f"stem_pool_q_{k}", "bfloat16"], int8_counts,
                       int8_stem) for k in ("2d", "3d")]
    line.append(_line_row(
        "int8_conv2d", conv, int8_counts,
        "none: no TPU kernel (XLA int8 conv, egot2x/nn/quant.py:102)",
        route="library (torch._int_mm)", source="egot2x_torch/ops/int8.py"))
    line.append(_flash_line_row(flash_rows, asd_counts))
    for row in line:   # the training paths' launches, beside the serving's
        row["train_launches"] = {path: counts[row["name"]]
                                 for path, counts in train_counts.items()}
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each printing one line or more:

  1. device   the card's name and power limit (nvidia-smi) and torch's name;
  2. build    nvcc of the kernels' source (time; registers, spills and
              shared memory of every kernel);
  3. kernel   each stem kernel against its plain PyTorch version on the card
              at the main paths' shapes: the float stems (f32, bf16) and the
              int8 stems (2D with 1 and 2 trunks stacked, 3D; f32 and bf16
              input), with its time beside the plain version's, a library
              yardstick's and the card's bound for the same work;
  4. int8conv the int8 conv (im2col + ``torch._int_mm``) against its exact
              plain version at a layer1 and a layer4 shape, bit for bit;
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
              and across the feeds.

Then one JSON line of every kernel, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line. Float32 runs in full f32 throughout: TF32 is off for cuDNN and for
matmuls, so the card and the CPU compute the same function.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
B, T, IMG, ASD_IMG = 16, 30, 224, 112   # one request: 16 clips of 30 frames
REQUESTS = 3
HIDDEN, LAYERS, HEADS = 128, 1, 4        # released flagship (bench.py)
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
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
    """'stem_pool_q_kernel<bf16,2d,n2>' from a mangled instance name."""
    import re

    m = re.search(r"(stem_pool(?:_q)?_kernel)I(f|13__nv_bfloat16)"
                  r"((?:Li\d+E)+)E", mangled)
    if not m:
        return mangled
    kind, dtype, args = m.groups()
    kt, _, *ng = [int(v) for v in re.findall(r"Li(\d+)E", args)]
    return (f"{kind}<{'f32' if dtype == 'f' else 'bf16'},"
            f"{'2d' if kt == 1 else '3d'}{''.join(f',n{g}' for g in ng)}>")


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
    from egot2x_torch.ops import build, stem

    b = build.build("stem_pool")
    report = _ptxas_report(b.log)
    phase("build", source=f"egot2x_torch/csrc/{b.name}.cu",
          seconds=round(b.seconds, 3),
          registers={k: r for k, (r, _) in report.items()},
          spill_store_bytes={k: s for k, (_, s) in report.items()},
          smem_bytes=stem.kernel_smem_bytes())
    if not report:
        fail("no kernel in the ptxas report")


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
    from egot2x_torch.ops import int8, stem

    return {"stem_pool_2d": stem.stem_pool_2d,
            "stem_pool_3d": stem.stem_pool_3d,
            "stem_pool_q_2d": stem.stem_pool_q_2d,
            "stem_pool_q_3d": stem.stem_pool_q_3d,
            "int8_conv2d": int8.conv2d_int8}


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


def _line_row(name, row, counts, replaces, route="cuda",
              source="egot2x_torch/csrc/stem_pool.cu"):
    return dict(name=name, route=route, source=source, replaces=replaces,
                dtype=str(row.get("dtype", "int8")),
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
    requests = list(_requests())
    float_counts, float_logits = slice_phase(card, requests)
    int8_counts = int8_slice_phase(card, requests, float_logits)
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
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each printing one line:

  1. device   the card's name and power limit (nvidia-smi) and torch's name;
  2. build    nvcc of the main path's kernel source (time, registers,
              spills, shared memory);
  3. kernel   each kernel against its plain PyTorch version on the card at
              the main path's shapes, f32 and bf16, with its time beside the
              plain version's, a one-call library yardstick's and the card's
              bound for the same work;
  4. slice    the flagship ``TaskFusionMFTransformer3Task`` at the released
              widths (hidden 128, 1 layer, 4 heads, FFN 2048; ResNet-18 at
              224^2, TalkNet at 112^2, f32) built by ``build_model``, random
              weights from a numpy seed in the JAX layout loaded through the
              weight bridge, answering requests of 16 clips x 30 frames with
              an f32 and a uint8 feed; the stem launch counts must show every
              stem went through the kernel, the logits must be finite, the
              feeds must agree, and clip 0 must match the port's CPU forward.

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
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# kernel vs plain: f32 as tests/test_pallas_stem.py holds the Pallas kernel;
# bf16 output is one rounding of the f32 result (2^-8 relative)
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
LOGIT_TOL = 1e-3   # card vs CPU, and uint8 vs f32 feed (rtol = atol)


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


def build_phase():
    import re

    from egot2x_torch.ops import build, stem

    b = build.build("stem_pool")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", b.log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", b.log)]
    phase("build", source=f"egot2x_torch/csrc/{b.name}.cu",
          seconds=round(b.seconds, 3), registers=regs,
          spill_store_bytes=spills, smem_bytes=stem.kernel_smem_bytes())


def _stem_case(kind, dtype):
    """Main-path inputs of one stem: (x, weight, scale, bias)."""
    import numpy as np
    import torch

    from egot2x_torch.ops import stem

    rng = np.random.default_rng(SEED)
    if kind == "2d":
        x = rng.standard_normal((B * T, IMG, IMG, 3), dtype=np.float32)
        wshape, fan_in = (64, 3, 7, 7), 147
    else:
        x = rng.uniform(-2.5, 3.5, (B, T, ASD_IMG, ASD_IMG)).astype(np.float32)
        wshape, fan_in = (64, 1, 5, 7, 7), 245
    w = (rng.standard_normal(wshape) / np.sqrt(fan_in)).astype(np.float32)
    bn = [rng.uniform(0.8, 1.2, 64), rng.standard_normal(64) * 0.05,
          rng.standard_normal(64) * 0.05, rng.uniform(0.8, 1.2, 64)]
    scale, bias = stem.fold_bn(*(torch.tensor(v) for v in bn),
                               1e-5 if kind == "2d" else 1e-3)
    cuda = lambda a: torch.as_tensor(a).cuda()
    return (cuda(x).to(getattr(torch, dtype)), cuda(w), cuda(scale),
            cuda(bias))


def _in_image_taps(n, k, stride, pad):
    """Taps of a k-wide window that land inside an axis of length n, summed
    over the conv's output positions along that axis."""
    n_out = (n + 2 * pad - k) // stride + 1
    return sum(sum(0 <= o * stride - pad + j < n for j in range(k))
               for o in range(n_out))


def _bound(kind, x, out):
    """Least time of the same work on the card: the conv's multiply-adds
    on in-image taps only (a tap in the zero padding needs no product;
    the BN, ReLU and pool epilogue, about 1%, is left out, so this stays
    a lower bound) over the peak of the input type, or input + output
    bytes over HBM bandwidth, whichever is larger."""
    if kind == "2d":
        n, h, w, c_in = x.shape
        taps = (n * c_in * _in_image_taps(h, 7, 2, 3)
                * _in_image_taps(w, 7, 2, 3))
    else:   # per-sample temporal pad of 2: the taps of each clip alone
        b, t, h, w = x.shape
        taps = (b * _in_image_taps(t, 5, 1, 2) * _in_image_taps(h, 7, 2, 3)
                * _in_image_taps(w, 7, 2, 3))
    flops = 2.0 * taps * 64
    nbytes = x.numel() * x.element_size() + out.numel() * out.element_size()
    t_ops = flops / PEAK_FLOPS[str(x.dtype).split(".")[1]]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def _library_call(kind, x, w, scale, bias):
    """One cuDNN conv with the BN folded into weight and bias, then ReLU
    and max-pool: the yardstick, used nowhere in the port."""
    import torch
    import torch.nn.functional as F

    wf = w * scale.view(-1, *([1] * (w.dim() - 1)))
    if kind == "2d":
        xin = x.permute(0, 3, 1, 2)          # channels_last view
        wf = wf.contiguous(memory_format=torch.channels_last)
        return lambda: F.max_pool2d(
            torch.relu_(F.conv2d(xin, wf, bias, 2, 3)), 3, 2, 1)
    xin = x.unsqueeze(1)
    return lambda: F.max_pool3d(
        torch.relu_(F.conv3d(xin, wf, bias, (1, 2, 2), (2, 3, 3))),
        (1, 3, 3), (1, 2, 2), (0, 1, 1))


def kernel_phase():
    """Each stem kernel vs its plain version, f32 and bf16; returns the
    f32 (main-path type) numbers per kernel."""
    import torch

    from egot2x_torch.ops import stem

    fns = {"2d": (stem.stem_pool_2d, stem.stem_pool_2d_plain),
           "3d": (stem.stem_pool_3d, stem.stem_pool_3d_plain)}
    results = {}
    for kind, (kernel, plain) in fns.items():
        for dtype in ("float32", "bfloat16"):
            x, w, scale, bias = _stem_case(kind, dtype)
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
                plain_ms=time_ms(lambda: plain(x, w, scale, bias)))
            if dtype == "float32":
                row["library_ms"] = time_ms(
                    _library_call(kind, x, w, scale, bias))
            (row["bound_ms"], row["bound_by"], row["flops"],
             row["bytes"]) = _bound(kind, x, out)
            phase("kernel", **row)
            if not ok:
                fail(f"stem_pool_{kind} {dtype} disagrees with its plain "
                     f"version: max abs err {row['max_abs_err']}")
            if dtype == "float32":
                results[kind] = row
            del x, out, ref, err
            torch.cuda.empty_cache()
    return results


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


def slice_phase(card):
    """The flagship on the card; returns the stem launches of the run."""
    import numpy as np
    import torch

    from egot2x_torch.core import bridge
    from egot2x_torch.core.registry import build_model
    from egot2x_torch.ops import stem

    kw = dict(hidden_dim=HIDDEN, num_heads=HEADS, num_layers=LAYERS)
    model = build_model("TaskFusionMFTransformer3Task", **kw)
    variables = bridge.random_jax_variables(model, SEED)
    bridge.load_jax_variables(model, variables)
    requests = list(_requests())
    audio = torch.zeros(B, T * 16000 // 30, device="cuda")  # unused stream
    on_card = [dict(f32=[torch.from_numpy(a).cuda() for a in r["f32"]],
                    u8=[torch.from_numpy(a).cuda() for a in r["u8"]],
                    mfcc=torch.from_numpy(r["mfcc"]).cuda())
               for r in requests]

    def forward(req, feed):
        video, grey = req[feed]
        return model(video, grey, audio, req["mfcc"])

    stem.stem_pool_2d.launches = stem.stem_pool_3d.launches = 0
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
    launches = {"stem_pool_2d": stem.stem_pool_2d.launches,
                "stem_pool_3d": stem.stem_pool_3d.launches}
    forwards = REQUESTS + 2
    expect = {"stem_pool_2d": 2 * forwards, "stem_pool_3d": forwards}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    phase("slice", card=card, model="TaskFusionMFTransformer3Task",
          hidden=HIDDEN, layers=LAYERS, heads=HEADS, clips=B, frames=T,
          requests=REQUESTS, clips_per_s=REQUESTS * B / seconds,
          ms_per_request=seconds / REQUESTS * 1e3, peak_mem_gib=peak_gib,
          stem_launches=launches, expected_launches=expect)
    if launches != expect:
        fail(f"stem launches {launches}, expected {expect}")
    for out in logits + [u8_logits]:
        if out.shape != (B, 2) or not bool(torch.isfinite(out).all()):
            fail(f"logits of shape {tuple(out.shape)}, finite "
                 f"{bool(torch.isfinite(out).all())}")
    feed_err = float((u8_logits - logits[0]).abs().max())

    # clip 0 of request 0 through the port on the CPU (plain stems)
    cpu = build_model("TaskFusionMFTransformer3Task", device="cpu", **kw)
    bridge.load_jax_variables(cpu, variables)
    with torch.no_grad():
        r0 = requests[0]
        want = cpu(torch.from_numpy(r0["f32"][0][:1]),
                   torch.from_numpy(r0["f32"][1][:1]), None,
                   torch.from_numpy(r0["mfcc"][:1]))[0]
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
    return launches


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
    kernels = kernel_phase()
    launches = slice_phase(card)
    line = []
    for kind, row in kernels.items():
        name = f"stem_pool_{kind}"
        line.append(dict(
            name=name, route="cuda", source="egot2x_torch/csrc/stem_pool.cu",
            replaces="egot2x/ops/pallas_stem.py:232",
            launches=launches[name], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

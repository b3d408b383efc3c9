"""Where the flagship's and the ASD model's time goes on the card.

One request of the released flagship (``TaskFusionMFTransformer3Task``,
hidden 128, 1 layer, 4 heads; 16 clips x 30 frames, ResNet-18 at 224^2,
TalkNet at 112^2; random weights from a numpy seed through the weight
bridge), timed with the host clock around synchronized forwards and
traced with ``torch.profiler``, in three settings: f32 with TF32 off (full
f32, the numbers ``chip_smoke.py`` reports), f32 with TF32 on for cuDNN and
matmuls (torch's default for convolutions), and the int8 bench
configuration (``quant=True``, ``fuse_stems=True``, bf16 compute,
calibrated on the request). Then Stage-I ASD (``TalkNetWithHeads``, f32
with TF32 off) on an eval bucket of 16 tracks x 150 frames and on one
track of 2048 frames, whose attention runs through the flash kernel.
Prints one JSON line per setting: ms per request, clips/s (frames/s for
ASD), the device's busy share of the wall time, device time by kernel
class, and the kernels ranked by device time.

    python -m egot2x_torch.tools.profile_flagship
"""

from __future__ import annotations

import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from egot2x_torch.core import bridge
from egot2x_torch.core.registry import build_model
from egot2x_torch.data.lam import normalize_frames
from egot2x_torch.nn.quant import calibrate

B, T = 16, 30
FORWARDS = 3


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (B, T, 224, 224, 3), dtype=np.uint8)
    grey = rng.integers(0, 256, (B, T, 112, 112), dtype=np.uint8)
    mfcc = rng.standard_normal((B, 4 * T, 13), dtype=np.float32)
    return [torch.from_numpy(a).cuda() for a in
            (normalize_frames(rgb), grey.astype(np.float32))], \
        torch.from_numpy(mfcc).cuda()


def _category(name: str) -> str:
    n = name.lower()
    if "flash_attention_kernel" in n:
        return "flash attention kernel (ours)"
    if "stem_pool_tc_kernel" in n:   # <KT, CIN, NG, F32IN, Tout>
        return ("int8 stem kernel (ours)" if "signed char" in n
                else "stem kernel (ours)")
    if (("gemm" in n or "xmma" in n or "cutlass" in n)
            and ("s8" in n or "i8" in n or "int8" in n or "imma" in n)):
        return "int8 matmul (torch._int_mm)"
    if "conv" in n or "xmma" in n or "implicit" in n or "winograd" in n:
        return "cuDNN convolution"
    if "gemm" in n or "cutlass" in n or "matmul" in n:
        return "matmul"
    if "batch_norm" in n or "bn_" in n:
        return "batch norm"
    if "reduce" in n or "mean" in n:
        return "reduction"
    return "elementwise and other"


def run(forward, tf32: bool):
    """Profile of ``forward()``, a request, after a warm-up."""
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    with torch.no_grad():
        forward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(FORWARDS):
            forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / FORWARDS * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(FORWARDS):
                forward()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) / FORWARDS * 1e3
    return dict(tf32=tf32, ms_per_request=wall_ms,
                **device_breakdown(prof, FORWARDS, traced_ms),
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)


def device_breakdown(prof, n: int, traced_ms: float) -> dict:
    """Device time of a trace of ``n`` repeats of a request or step whose
    wall time under the profiler was ``traced_ms`` each: the busy time
    and share, by kernel class, and the top kernels, per repeat."""
    kernels, cats = {}, defaultdict(float)
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = us / 1e3 / n
        kernels[ev.key] = (ms, ev.count // n)
        cats[_category(ev.key)] += ms
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(
        traced_ms_per_request=traced_ms, device_busy_ms=busy,
        device_busy_share=busy / traced_ms if traced_ms else None,
        by_category={k: v for k, v in sorted(cats.items(),
                                             key=lambda kv: -kv[1])},
        top_kernels=[dict(name=k[:90], ms=ms, launches=n)
                     for k, (ms, n) in top])


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    inputs, mfcc = _inputs()
    for config in ({}, dict(quant=True, fuse_stems=True,
                            dtype=torch.bfloat16)):
        model = build_model("TaskFusionMFTransformer3Task", hidden_dim=128,
                            num_heads=4, num_layers=1, **config)
        bridge.load_jax_variables(model,
                                  bridge.random_jax_variables(model, 0))
        name = "float"
        if config:
            calibrate(model, *inputs, None, mfcc)
            name = "int8 (quant, fuse_stems, bf16)"
        for tf32 in ((False, True) if not config else (False,)):
            row = run(lambda: model(*inputs, None, mfcc), tf32)
            print(json.dumps(dict(
                card=card, config=name, clips=B, frames=T,
                clips_per_s=B * 1e3 / row["ms_per_request"], **row)),
                flush=True)
        del model
    model = build_model("TalkNetWithHeads")
    bridge.load_jax_variables(model, bridge.random_jax_variables(model, 0))
    rng = np.random.default_rng(2)
    for tracks, frames in ((16, 150), (1, 2048)):
        faces = torch.from_numpy(rng.integers(
            0, 256, (tracks, frames, 112, 112), dtype=np.uint8)).cuda().float()
        mfcc = torch.from_numpy(rng.standard_normal(
            (tracks, 4 * frames, 13), dtype=np.float32)).cuda()
        row = run(lambda: model(mfcc, faces), False)
        print(json.dumps(dict(
            card=card, config="asd TalkNetWithHeads", tracks=tracks,
            frames=frames,
            frames_per_s=tracks * frames * 1e3 / row["ms_per_request"],
            **row)), flush=True)


if __name__ == "__main__":
    main()

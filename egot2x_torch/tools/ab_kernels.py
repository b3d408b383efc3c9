"""Time this checkout's int8 stem and flash kernels against another
checkout's, in one process on one card.

    python -m egot2x_torch.tools.ab_kernels --other DIR [--iters 20]

DIR is the root of another checkout of this repository, e.g. an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists. Both checkouts' ``csrc/stem_pool.cu`` and ``csrc/flash_attention.cu``
are compiled with ``ops/build.py``'s nvcc flags into ``build/ab/``, loaded
with ctypes and launched through their C entry points on the same inputs,
at the main paths' shapes:

* flash attention at TalkNet's 2048-frame track, (8, 2048, 2048) at D 16
  and 32, f32 and bf16;
* the int8 stems at one request (480 frames): 2D with LAM and TTM stacked
  at 224^2 and the TalkNet 3D stem at 112^2, bf16 and f32 input.

Each case is timed in turns (other, this, this, other), by replaying a
CUDA graph of ``--iters`` launches between two events, and prints one
JSON line: both times (the mean of each side's two turns),
their ratio, and the largest difference between the two outputs. The
other checkout's int8 stem takes f32 taps ((n, 7, 7, 3, 64) or (1, 5, 7,
7, 64)) for both
input types, as it did before the tensor-core kernel; this checkout's
takes ``ops.stem._kernel_weights``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from egot2x_torch.ops import build, stem

AB_DIR = build.BUILD_DIR.parent / "ab"
SOURCES = ("stem_pool", "flash_attention")


def _compile(root: Path, tag: str):
    """{source: CDLL} of ``root``'s kernels, built in parallel."""
    AB_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        src = root / "egot2x_torch" / "csrc" / f"{name}.cu"
        out = AB_DIR / f"{name}-{tag}.so"
        procs[name] = (out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag} {name}.cu:\n{log}")
        lib = ctypes.CDLL(str(out))
        if name == "flash_attention":
            lib.egot2x_flash_attention.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
        else:
            lib.egot2x_stem_pool_q.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def _events_ms(fn, iters):
    """Device time of one call: ``iters`` calls captured in a CUDA graph
    and replayed, so that the host's cost of a ctypes launch (tens of
    microseconds, as long as a flash launch) is not what is timed."""
    fn()
    torch.cuda.synchronize()
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


def _flash_call(lib, q, k, v, out):
    bh, n, d = q.shape
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if q.dtype == torch.float32 else 1, bh, 1, n, k.shape[1], d]
    for x in (q, k, v, out):
        args += [x.stride(0), 0, x.stride(1)]

    def call():
        err = lib.egot2x_flash_attention(
            *args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash launch failed: {err}")
    return call


def _stem_call(lib, kind, x, w, scale, bias, steps, out):
    ng = steps.numel()
    b, t, h, wd = ((x.shape[0], 1, x.shape[1], x.shape[2]) if kind == 2
                   else tuple(x.shape))

    def call():
        err = lib.egot2x_stem_pool_q(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            steps.data_ptr(), out.data_ptr(), kind,
            0 if x.dtype == torch.float32 else 1, ng, b, t, h, wd,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"stem launch failed: {err}")
    return call


def _ab(name, calls, outs, iters):
    """Times in turns other, this, this, other; one JSON line."""
    other, this = calls
    t = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        t[side].append(_events_ms(other if side == "other" else this, iters))
    diff = float((outs[0].float() - outs[1].float()).abs().max())
    row = dict(case=name, other_ms=sum(t["other"]) / 2,
               this_ms=sum(t["this"]) / 2, turns=t, max_abs_diff=diff)
    row["speedup"] = row["other_ms"] / row["this_ms"]
    print(json.dumps(row), flush=True)
    return row


def flash_cases(libs, iters):
    rng = np.random.default_rng(0)
    for d in (16, 32):
        host = [rng.standard_normal((8, 2048, d)).astype(np.float32)
                for _ in range(3)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(a).cuda().to(dtype) for a in host)
            outs = [torch.empty_like(q) for _ in libs]
            calls = [_flash_call(lib["flash_attention"], q, k, v, o)
                     for lib, o in zip(libs, outs)]
            _ab(f"flash (8, 2048, {d}) {str(dtype)[6:]}", calls, outs, iters)


def stem_cases(libs, iters):
    rng = np.random.default_rng(1)
    cases = [("2d n=2", 2, (480, 224, 224, 3), 2),
             ("3d", 3, (16, 30, 112, 112), 1)]
    for name, kind, shape, ng in cases:
        tap_shape = (ng, 7, 7, 3, 64) if kind == 2 else (1, 5, 7, 7, 64)
        taps = torch.from_numpy((rng.standard_normal(tap_shape) * 0.05)
                                .astype(np.float32)).cuda()
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, 64 * ng)
                                 .astype(np.float32)).cuda()
        bias = torch.from_numpy((rng.standard_normal(64 * ng) * 0.1)
                                .astype(np.float32)).cuda()
        steps = torch.full((ng,), 0.02, device="cuda")
        x32 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.cuda().to(dtype)
            pooled = [stem.pooled_size(n) for n in shape[-3:-1]] \
                if kind == 2 else [stem.pooled_size(n) for n in shape[-2:]]
            frames = shape[0] if kind == 2 else shape[0] * shape[1]
            outs = [torch.empty((frames, *pooled, 64 * ng), dtype=torch.int8,
                                device="cuda") for _ in libs]
            weights = [taps, stem._kernel_weights(kind, taps, dtype)]
            calls = [_stem_call(lib["stem_pool"], kind, x, w, scale, bias,
                                steps, o)
                     for lib, w, o in zip(libs, weights, outs)]
            _ab(f"stem_pool_q {name} {str(dtype)[6:]}", calls, outs, iters)
            del x, outs
            torch.cuda.empty_cache()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path, required=True,
                        help="root of the other checkout")
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ab_kernels: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parents[2]
    libs = [_compile(args.other.resolve(), "other"), _compile(root, "this")]
    print(json.dumps({"build_seconds": time.perf_counter() - t0}), flush=True)
    flash_cases(libs, args.iters)
    stem_cases(libs, args.iters)


if __name__ == "__main__":
    main()

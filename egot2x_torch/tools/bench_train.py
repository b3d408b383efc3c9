"""Training-step throughput of the flagship EgoT2-s TTM 3-task translator.

The port of ``tools/bench_train.py`` at its defaults: one train step of
``TaskFusionMFTransformer3Task`` through ``TalkingToMe2Loader`` (the
three frozen backbones' forward, the weighted CE, the translator's
backward and its Adam update), batch 64 clips of T = 30 frames at 224^2,
bf16 compute, hidden 128, 1 layer, 4 heads, dropout 0.5; ``QUANT=1`` runs
the frozen trunks int8 (static PTQ, calibrated on the feed batch). The
feed is drawn on the device from a seed: normalized f32 frames, grey
faces, raw audio, MFCC. One warm-up step, then ``N_ITER`` steps timed with
the host clock between two ``torch.cuda.synchronize()``, then a profiled
window of 3 steps for the device's busy share.

    python -m egot2x_torch.tools.bench_train        # BATCH, T, N_ITER, QUANT

Prints one JSON line: train clips/s and steps/s on the named device, peak
device memory, the device busy share. It compares with no TPU number.
"""

from __future__ import annotations

import json
import os
import time

import torch

from egot2x_torch.core.config import Config
from egot2x_torch.tasks.ttm_2loader import TalkingToMe2Loader

PROFILED_STEPS = 3


def _feed(batch, t, img, device, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    draw = lambda *shape: torch.randn(shape, generator=g, device=device)
    return {"frames": draw(batch, t, img, img, 3),
            "video_asd": draw(batch, t, 112, 112),
            "audio": draw(batch, t * 16000 // 30),
            "audio_asd": draw(batch, 4 * t, 13),
            "label": torch.randint(0, 2, (batch,), generator=g,
                                   device=device)}


def run(batch=64, t=30, n_iter=10, quant=False, img=224, device=None):
    """The bench's numbers as a dict; ``device="cpu"`` runs the plain
    versions (a smoke, no device metrics)."""
    cfg = Config(
        model="TaskFusionMFTransformer3Task", weights=[0.266, 0.734],
        lr=1e-4, wd=1e-4, seed=0, hidden_dim=128, num_layers=1,
        num_heads=4, dropout=0.5, quant_trunks=quant, compute_dtype="bf16")
    task = TalkingToMe2Loader(cfg, device=device)
    state = task.build_state(cfg.seed)
    dev = next(state.model.parameters()).device
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: 0)
    feed = _feed(batch, t, img, dev)
    if quant:
        task.calibrate_state(state, feed)
    generator = torch.Generator(dev).manual_seed(cfg.seed + 1)
    state, metrics = task.train_step(state, feed, generator)   # warm-up
    first_loss = float(metrics["loss"])
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        state, metrics = task.train_step(state, feed, generator)
    sync()
    dt = time.perf_counter() - t0
    out = {
        "metric": "egot2s_ttm_3task_train_clips_per_sec",
        "value": batch * n_iter / dt, "unit": "clips/s",
        "steps_per_sec": n_iter / dt,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "first_loss": first_loss, "last_loss": float(metrics["loss"]),
        "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if on_card else None),
        "device_busy_share": None,
        "config": (f"bf16 train step, "
                   + ("int8 frozen trunks" if quant else "frozen backbones")
                   + f", Adam, dropout 0.5, batch {batch}, T={t}, {img}^2")}
    if on_card:
        from torch.profiler import ProfilerActivity, profile

        from egot2x_torch.tools.profile_flagship import device_breakdown

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                state, metrics = task.train_step(state, feed, generator)
            sync()
            traced_ms = (time.perf_counter() - t0) / PROFILED_STEPS * 1e3
        trace = device_breakdown(prof, PROFILED_STEPS, traced_ms)
        out["device_busy_share"] = trace["device_busy_share"]
        out["ms_per_step_traced"] = traced_ms
        out["device_ms_by_category"] = trace["by_category"]
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bench_train measures the card: no CUDA device")
    print(json.dumps(run(batch=int(os.environ.get("BATCH", "64")),
                         t=int(os.environ.get("T", "30")),
                         n_iter=int(os.environ.get("N_ITER", "10")),
                         quant=bool(int(os.environ.get("QUANT", "0"))))))


if __name__ == "__main__":
    main()

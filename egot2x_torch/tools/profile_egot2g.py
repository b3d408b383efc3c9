"""Where the EgoT2-g HHI paths' time goes on the card.

``Unified3TaskTranslation`` and ``Unified3Task`` at ``run_multitask``'s
widths (hidden 256, 4 heads, 3 layers, FFN 2048; seeded weights through
``build_state``), f32 with TF32 off, on one combined batch
(:func:`combined_batches`: LAM 4 clips x 7 frames, TTM and ASD 2 x 15,
RGB at 224^2): each task's eval step, the translation task's frozen train
step (dropout 0.1), and the translation model's ASD ``predict`` on one
700-frame track, whose prompt encoder runs through the flash kernel.
Each path: a warm-up, ``REPEATS`` repeats timed with the host clock
between two ``torch.cuda.synchronize()``, then ``REPEATS`` traced with
``torch.profiler``. Prints one JSON line a path: ms a repeat, the
device's busy share of the traced wall time, device time by kernel class
and the kernels ranked by device time (``tools/profile_flagship.py``'s
classes), peak memory.

    python -m egot2x_torch.tools.profile_egot2g
"""

from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from egot2x_torch.core.config import Config
from egot2x_torch.nn.resnet2d import normalize_u8_frames
from egot2x_torch.tasks import multitask_hhi
from egot2x_torch.tools.profile_flagship import device_breakdown

REPEATS = 3
LAM_CLIPS, LAM_FRAMES, CLIPS, FRAMES, IMG = 4, 7, 2, 15, 224
LONG_TRACK = 700   # 3 x 700 prompt tokens: the flash route
TASK_IDS = {"lam": 3, "ttm": 2, "asd": 4}   # the HHI vocabulary's


def config() -> Config:
    """``run_multitask``'s defaults."""
    return Config(hidden_dim=256, num_heads=4, num_layers=3, dropout=0.1,
                  lr=1e-4)


def combined_batches(n: int, seed: int, device="cuda"):
    """``n`` combined batches ``{task: batch}`` drawn on ``device`` from
    ``seed``: RGB normalized from uint8, grey faces in [0, 255], raw audio
    (unused by the trunks), MFCC, and target sequences [task token, '0' or
    '1', '</s>'] (ASD's one a frame)."""
    g = torch.Generator(device).manual_seed(seed)
    u8 = lambda *shape: torch.randint(0, 256, shape, generator=g,
                                      device=device, dtype=torch.uint8)
    rgb = lambda n, t: normalize_u8_frames(u8(n, t, IMG, IMG, 3))
    grey = lambda n, t: u8(n, t, 112, 112).float()
    wave = lambda n, t: torch.zeros(n, t * 16000 // 30, device=device)
    mfcc = lambda n, t: torch.randn(n, 4 * t, 13, generator=g,
                                    device=device)

    def target(task, *shape):
        label = torch.randint(0, 2, shape, generator=g, device=device)
        return torch.stack([torch.full_like(label, TASK_IDS[task]),
                            5 + label, torch.zeros_like(label)], dim=-1)

    return [{"lam": dict(frames=rgb(LAM_CLIPS, LAM_FRAMES),
                         target_seq=target("lam", LAM_CLIPS)),
             "ttm": dict(frames=rgb(CLIPS, FRAMES), video_asd=grey(CLIPS,
                                                                  FRAMES),
                         audio=wave(CLIPS, FRAMES),
                         audio_asd=mfcc(CLIPS, FRAMES),
                         target_seq=target("ttm", CLIPS)),
             "asd": dict(frames=rgb(CLIPS, FRAMES), faces=grey(CLIPS, FRAMES),
                         audio=wave(CLIPS, FRAMES), mfcc=mfcc(CLIPS, FRAMES),
                         target_seq=target("asd", CLIPS, FRAMES))}
            for _ in range(n)]


def _profile(step) -> dict:
    """Wall ms a repeat of ``step()`` and the device breakdown of a
    trace of REPEATS more, after a warm-up."""
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(REPEATS):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / REPEATS * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REPEATS):
            step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / REPEATS * 1e3
    return dict(ms=wall_ms, **device_breakdown(prof, REPEATS, traced_ms),
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    batch = combined_batches(1, 0)[0]
    report = lambda path, row: print(json.dumps(dict(card=card, path=path,
                                                     **row)), flush=True)
    for name in ("Unified3TaskTranslation", "Unified3Task"):
        task = getattr(multitask_hhi, name)(config())
        state = task.build_state(0)
        report(f"{name} eval_step", _profile(
            lambda: task.eval_step(state, batch)))
        if name != "Unified3TaskTranslation":
            continue
        generator = torch.Generator("cuda").manual_seed(1)
        report(f"{name} train_step", _profile(
            lambda: task.train_step(state, batch, generator)))
        g = torch.Generator("cuda").manual_seed(2)
        track = (normalize_u8_frames(torch.randint(
                     0, 256, (1, LONG_TRACK, IMG, IMG, 3), generator=g,
                     device="cuda", dtype=torch.uint8)),
                 torch.randint(0, 256, (1, LONG_TRACK, 112, 112),
                               generator=g, device="cuda").float(),
                 None,
                 torch.randn(1, 4 * LONG_TRACK, 13, generator=g,
                             device="cuda"))
        model = state.model.eval()
        report(f"{name} asd predict, 1 x {LONG_TRACK} frames", _profile(
            lambda: model.predict(*track, "asd")))


if __name__ == "__main__":
    main()

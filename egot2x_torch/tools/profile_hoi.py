"""Where the HOI Stage-I models' time goes on the card.

``StateChangeClsResNet``, ``KeyframeLocalizationResNet`` (with dot_product
Nonlocals after res3 and res4 block 1) and ``KeyframeCnnLSTM`` at
pnr_train's defaults (batch 16, 16 frames, crop 225, ``slow_layer5``,
depth 50, raw [0, 255] frames; random weights from a numpy seed through
the weight bridge), each timed with the host clock around synchronized
forwards and traced with ``torch.profiler``: f32 with TF32 off (the
numbers ``chip_smoke.py`` reports), f32 with TF32 on, and bf16 compute.
For the ResNet3D models the f32 forward is also run with the trunk in
plain NCDHW memory (weights and activations contiguous) against the
channels_last_3d layout the port keeps, in turns (channels-last, NCDHW,
NCDHW, channels-last). Prints one JSON line per run: ms a batch, clips/s,
the device's busy share, device time by kernel class, the top kernels and
peak memory, with the card's name and power limit.

    python -m egot2x_torch.tools.profile_hoi
"""

from __future__ import annotations

import contextlib
import json
import subprocess

import numpy as np
import torch

from egot2x_torch.core import bridge
from egot2x_torch.core.registry import build_model
from egot2x_torch.nn import resnet3d
from egot2x_torch.tools.profile_flagship import run

B, T, CROP = 16, 16, 225
NONLOCAL = [[[]], [[1]], [[1]], [[]]]
MODELS = (("StateChangeClsResNet", dict(crop_size=CROP)),
          ("KeyframeLocalizationResNet",
           dict(crop_size=CROP,
                nonlocal_cfg=resnet3d.resolve_nonlocal(NONLOCAL))),
          ("KeyframeCnnLSTM", dict()))


@contextlib.contextmanager
def ncdhw(model):
    """The trunk in plain NCDHW memory: contiguous conv weights, and the
    frames' NCTHW view made contiguous where the stem takes it."""
    convs = [m for m in model.modules() if getattr(m, "channels_last", False)]
    view = resnet3d._to_ncthw
    for m in convs:
        m.weight.data = m.weight.data.contiguous()
    resnet3d._to_ncthw = lambda x: view(x).contiguous()
    try:
        yield
    finally:
        resnet3d._to_ncthw = view
        for m in convs:
            m.weight.data = m.weight.data.contiguous(
                memory_format=torch.channels_last_3d)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(
        0, 256, (B, T, CROP, CROP, 3), dtype=np.uint8)).cuda().float()
    for name, kw in MODELS:
        settings = [("f32", torch.float32, False), ("f32 tf32", torch.float32,
                                                     True),
                    ("bf16", torch.bfloat16, False)]
        for label, dtype, tf32 in settings:
            model = build_model(name, dtype=dtype, **kw)
            bridge.load_jax_variables(model,
                                      bridge.random_jax_variables(model, 0))
            layouts = ([("channels_last_3d", contextlib.nullcontext),
                        ("ncdhw", lambda: ncdhw(model))] * 2
                       if label == "f32" and name != "KeyframeCnnLSTM"
                       else [("channels_last_3d", contextlib.nullcontext)])
            if len(layouts) == 4:   # in turns: cl, ncdhw, ncdhw, cl
                layouts[2], layouts[3] = layouts[3], layouts[2]
            for layout, ctx in layouts:
                with ctx():
                    row = run(lambda: model(frames), tf32)
                print(json.dumps(dict(
                    card=card, model=name, setting=label, layout=layout,
                    clips=B, frames=T, crop=CROP,
                    clips_per_s=B * 1e3 / row["ms_per_request"],
                    **row)), flush=True)
            del model
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

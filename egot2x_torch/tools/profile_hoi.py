"""Where the HOI models' time goes on the card.

Stage I: ``StateChangeClsResNet``, ``KeyframeLocalizationResNet`` (with
dot_product Nonlocals after res3 and res4 block 1) and ``KeyframeCnnLSTM``
at pnr_train's defaults (batch 16, 16 frames, crop 225, ``slow_layer5``,
depth 50, raw [0, 255] frames). Stage II: ts_pnr
(``TaskFusionMFTransformer3TaskDropout`` at ``configs/pnr/ts_pnr.yaml``'s
widths, D 128, 6 layers) at tools/bench_hoi.py's geometry: batch 8, 16
raw frames of 225^2 for its PNR and OSCC ResNet3D-50s, SlowFast-R50
pathways of 8 slow and 32 fast frames at 224^2 (alpha 4). Random weights
from a numpy seed through the weight bridge (timing only: no BN is
fitted). Each is timed with the host clock around synchronized forwards
and traced with ``torch.profiler``: f32 with TF32 off (the numbers
``chip_smoke.py`` reports), f32 with TF32 on, and bf16 compute. For the
ResNet3D models and ts_pnr the f32 forward is also run with the trunks in
plain NCDHW memory (weights and activations contiguous) against the
channels_last_3d layout the port keeps, in turns (channels-last, NCDHW,
NCDHW, channels-last). Prints one JSON line per run: ms a batch, clips/s,
the device's busy share, device time by kernel class, the top kernels and
peak memory, with the card's name and power limit, and the FLOPs of a
batch counted from the conv and matmul shapes.

With ``--quant`` the models that take ``quant`` (the two ResNet3D models
and ts_pnr) run their int8 trunks instead, calibrated on one batch drawn
apart from the timed one, f32 (TF32 off) and bf16, channels_last_3d; the
device time splits the int8 conv's parts into their own classes: the int8
matmul (``torch._int_mm``), the quantizer's rounding and clamping, and
copies (the im2col and the casts).

    python -m egot2x_torch.tools.profile_hoi [--model NAME ...] [--quant]
    python -m egot2x_torch.tools.profile_hoi --flops   # the counts only,
                                                       # on the CPU
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess

import numpy as np
import torch

from egot2x_torch.core import bridge
from egot2x_torch.core.registry import MODEL_REGISTRY, build_model
from egot2x_torch.nn import resnet3d
from egot2x_torch.nn.quant import assert_calibrated, calibrate
from egot2x_torch.tools.profile_flagship import int8_category, run

B, T, CROP = 16, 16, 225
TS_B, TS_FAST, TS_IMG, TS_ALPHA = 8, 32, 224, 4
NONLOCAL = [[[]], [[1]], [[1]], [[]]]
MODELS = (("StateChangeClsResNet", dict(crop_size=CROP)),
          ("KeyframeLocalizationResNet",
           dict(crop_size=CROP,
                nonlocal_cfg=resnet3d.resolve_nonlocal(NONLOCAL))),
          ("KeyframeCnnLSTM", dict()),
          ("TaskFusionMFTransformer3TaskDropout",
           dict(target="keyframe", feature_dim=128, num_layers=6,
                crop_size=CROP, alpha=TS_ALPHA)))
STAGE2 = "TaskFusionMFTransformer3TaskDropout"


def shapes(name):
    """(batch, the frames' shape, the pathways' shapes or None)."""
    if name != STAGE2:
        return B, (B, T, CROP, CROP, 3), None
    return TS_B, (TS_B, T, CROP, CROP, 3), [
        (TS_B, t, TS_IMG, TS_IMG, 3) for t in (TS_FAST // TS_ALPHA, TS_FAST)]


def inputs(name, seed=0):
    """The model's batch of random inputs on the card (float: raw [0, 255]
    frames; standard-normal pathways, as tools/bench_hoi.py feeds)."""
    rng = np.random.default_rng(seed)
    batch, frame_shape, path_shapes = shapes(name)
    frames = torch.from_numpy(rng.integers(
        0, 256, frame_shape, dtype=np.uint8)).cuda().float()
    if path_shapes is None:
        return batch, (frames,)
    return batch, (frames, [torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).cuda() for shape in path_shapes])


def count_flops(name, kw):
    """FLOPs (2 a multiply-add) of a batch's forward, from the conv and
    matmul shapes, traced on the meta device (nothing is computed); None
    for ``KeyframeCnnLSTM``, whose stem kernel takes no meta tensor."""
    from torch.utils.flop_counter import FlopCounterMode

    from egot2x_torch.core.registry import register_models

    if name == "KeyframeCnnLSTM":
        return None
    register_models()
    _, frame_shape, path_shapes = shapes(name)
    with torch.device("meta"):
        model = MODEL_REGISTRY.get(name)(**kw).eval()
        args = (torch.empty(frame_shape),) + (
            () if path_shapes is None
            else ([torch.empty(shape) for shape in path_shapes],))
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(*args)
    return counter.get_total_flops()


@contextlib.contextmanager
def ncdhw(model):
    """The trunks in plain NCDHW memory: contiguous conv weights, and the
    frames' NCTHW view made contiguous where the stems take it."""
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
    parser = argparse.ArgumentParser()
    parser.add_argument("--flops", action="store_true",
                        help="print each model's FLOPs a batch and exit")
    parser.add_argument("--model", action="append",
                        choices=[name for name, _ in MODELS],
                        help="only these models (repeatable; default all)")
    parser.add_argument("--quant", action="store_true",
                        help="the int8 trunks, calibrated on one batch")
    args = parser.parse_args()
    models = [(name, kw) for name, kw in MODELS
              if (not args.model or name in args.model)
              and not (args.quant and name == "KeyframeCnnLSTM")]
    if args.flops:
        for name, kw in models:
            batch = shapes(name)[0]
            flops = count_flops(name, kw)
            print(json.dumps(dict(
                model=name, clips=batch, flops_per_batch=flops,
                gflop_per_clip=flops and flops / batch / 1e9)))
        return
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    for name, kw in models:
        batch, x = inputs(name)
        flops = count_flops(name, kw)
        settings = [("f32", torch.float32, False), ("f32 tf32", torch.float32,
                                                     True),
                    ("bf16", torch.bfloat16, False)]
        classes = {}
        if args.quant:
            settings = [("int8 f32", torch.float32, False),
                        ("int8 bf16", torch.bfloat16, False)]
            classes = dict(classes=int8_category)
        for label, dtype, tf32 in settings:
            model = build_model(name, dtype=dtype, quant=args.quant, **kw)
            bridge.load_jax_variables(model,
                                      bridge.random_jax_variables(model, 0))
            if args.quant:
                calibrate(model, *inputs(name, seed=1)[1])
                assert_calibrated(model)
            layouts = ([("channels_last_3d", contextlib.nullcontext),
                        ("ncdhw", lambda: ncdhw(model))] * 2
                       if label == "f32" and name != "KeyframeCnnLSTM"
                       else [("channels_last_3d", contextlib.nullcontext)])
            if len(layouts) == 4:   # in turns: cl, ncdhw, ncdhw, cl
                layouts[2], layouts[3] = layouts[3], layouts[2]
            for layout, ctx in layouts:
                with ctx():
                    row = run(lambda: model(*x), tf32, **classes)
                print(json.dumps(dict(
                    card=card, model=name, setting=label, layout=layout,
                    clips=batch, frames=T, crop=CROP,
                    clips_per_s=batch * 1e3 / row["ms_per_request"],
                    flops_per_batch=flops,
                    tflop_per_s=flops and flops / row["ms_per_request"]
                    / 1e9,
                    **row)), flush=True)
            del model
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

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
              track ((8, 2048, 16) and (8, 2048, 32)), the EgoT2-g prompt
              encoder's on a 700-frame ASD track ((4, 2100, 64)), D 256
              and the JAX oracle's odd (2, 257, 40) over 130 keys, f32 and
              bf16, with its time
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
              at the int8 bars (loss 1e-2 relative, cosine >= 0.99);
 11. stem_bwd  (after phase 3) the float stem's training variant (winners
              and their conv values beside the output) and its backward
              kernel at the training shapes (2D at 480 frames of 224^2, 3D
              at 16 x 30 x 112^2), f32 and bf16: winners against
              ``F.max_pool2d``'s outside near-ties (counted), dy and the
              per-channel sums against the plain backward on the same
              saved tensors, and the differentiable stem's gradients
              against autograd of the plain version; times of the training
              forward, the backward kernel, the library weight gradient,
              the whole stem's forward and backward, the plain version's
              autograd and a library yardstick (autograd of cuDNN conv,
              BN, ReLU, max-pool), and the bound;
 12. train_full  Stage-II training of the flagship with trainable trunks
              (``nofreeze``) at full width and depth, f32 with TF32 off,
              16 clips x 30 frames, without and with ``remat``: launch
              counts a step (2 + 1 stems forward, twice under remat, 3
              backward), finite losses, every leaf moved, the trunks' BN
              statistics bit for bit, peak memory; one step card vs CPU on
              2 clips (loss 1e-4 relative, each leaf's gradient within
              5e-2 of its norm and at cosine >= 0.999); remat's first
              loss equal to the other's;
 13. asd2_train  the ASD 2-loader task's steps (``ActiveSpeakerDetection2
              Loader``, the translator at its defaults behind lossAV),
              frozen and ``nofreeze``, on a bucket of 4 tracks x 150
              frames with RGB at 224^2: launch counts, finite losses,
              every trainable leaf moved, the trunks' statistics, one
              validation batch.
 14. stage1_lam  Stage-I LAM training (``LookingAtMe`` on ``BaselineLSTM``,
              run_lam's defaults: 64 clips x 7 frames of 224^2, lr 5e-4,
              class weights [0.136, 0.864]), f32 with TF32 off: a warm-up
              and 3 timed steps with no kernel launch (the stems' BNs take
              batch statistics, which no kernel computes: library conv,
              BN, ReLU and pool, where the JAX package runs XLA), finite
              losses, every leaf moved (but exact-zero gradients), every
              BN running statistic moved; one validation batch through
              ``eval_step`` with one ``stem_pool_2d`` launch (eval BN);
              one ``GazeLSTM`` step; one step on 2 clips on the card
              against the same step on the CPU in f64 (loss and running
              statistics 1e-4 relative, gradients at the train_full bars);
 15. stage1_ttm  the same for ``TalkingToMe`` on ``TTMBaselineLSTM`` at
              run_ttm's 400-frame budget: buckets of 26 x 15 and 2 x 150
              frames with their raw audio, each warmed up, then 3 timed
              steps (15, 150, 15);
 16. stage1_asd  the same for ``ActiveSpeakerDetection`` on
              ``TalkNetWithHeads`` at run_asd's 2500-frame budget, 16
              tracks x 150 faces of 112^2 with MFCC, lr 1e-4 decayed 0.95
              a step, dropout 0.1 (off for the card vs CPU step); its
              validation launches one ``stem_pool_3d``.
 17. egot2g  EgoT2-g HHI at run_multitask's widths (hidden 256, 4 heads, 3
              layers, FFN 2048, dropout 0.1, lr 1e-4), seeded weights
              through ``build_state``, on one combined batch (LAM 4 clips
              x 7 frames, TTM and ASD 2 x 15 frames, RGB at 224^2, grey
              faces, raw audio, MFCC): ``Unified3TaskTranslation`` and
              ``Unified3Task`` answer it through ``eval_step`` (one
              encoding a task: 5 + 2 and 2 + 1 stem launches; clip 0 of
              each task against the port's CPU ``predict``); ASD
              ``predict`` of the translation model on one 700-frame track
              (three flash launches at (4, 2100, 64), one an encoder layer,
              checked against plain attention); then a warm-up and 3 timed
              frozen train steps of ``Unified3TaskTranslation`` (f32, TF32
              off): launch counts, finite losses, every core leaf moved,
              the backbones bit for bit, one step with dropout off on 2
              clips of each task against the CPU's (loss 1e-4 relative,
              gradient cosine >= 0.99999); ``Trainer.fit`` with
              ``fast_dev_run`` on a ``CombinedLoader`` (one step and one
              validation batch, their launch counts).
then the HHI data path (the data plane's nvJPEG, ``jpeg.cu``, is built
with the kernels, and its version printed after the build):
 18. data    nvJPEG's decode of the committed cv2-written reference JPEGs
              (egot2x_torch/tools/jpeg_refs, made by tools/make_jpeg_refs.py)
              against cv2's decode: max |diff| and the share of pixels that
              differ printed; the 4:4:4 file within 3 levels, the 4:2:0
              files' luma within a mean of 1 (chroma upsampling is the
              decoder's choice), every file's chroma averaged over 2x2
              blocks within a mean of 3 (a Cb/Cr swap must fail it); an
              nvJPEG encode-decode round trip; the
              ``crop_resize`` kernel against its plain version bit for bit
              on one 150-frame item of 512^2 frames (256^2 face boxes ->
              224^2 RGB; grey squares past the frame's edge, flipped),
              its time (a CUDA graph of launches) beside the wrapper's, the
              plain version's, ``F.interpolate``'s on the stacked crops and
              the byte bound; decode and loader rates on 64 such frames;
 19. cli     ``run_ttm.main`` with ``--two_loader --model
              TaskFusionMFTransformer3Task`` at the CLI's widths (hidden 256,
              4 heads, 3 layers, dropout 0.1, lr 5e-4, 400-frame batches,
              10 loader threads, 224^2) for one epoch on a TTM fixture of
              512^2 frames written by nvJPEG's encoder: every batch from the
              card loader (CUDA tensors before the Trainer moves anything),
              2 + 1 stems a step and a forward, 2 crop_resize launches an
              item and one decode a frame, all counted from 0; ms a step,
              the loader wait, peak memory, the validation metrics; then
              ``run_lam``, ``run_asd`` (plain and ``--two_loader``) and
              ``run_multitask`` (both tasks) with ``--synthetic
              --fast_dev_run`` on the card.

then the TTM baselines and HOI Stage-I inference:
 20. ttm_baselines  ``FinetuneTTM``, ``LAM2TTM``, ``ASD2TTM`` and
              ``TaskFusionLFLinear3Task`` at run_ttm --two_loader's widths
              (hidden 256, ``hidden_dim2`` 512) with seeded weights on one
              request of 16 clips x 30 frames (RGB 224^2, faces 112^2,
              MFCC), f32 and uint8 feeds: one 2D stem launch a forward of
              the first two, one 3D of the third, 2 + 1 of the late fusion,
              exact; clip 0 against the port's CPU forward; one frozen
              ``FinetuneTTM`` train step through ``TalkingToMe2Loader``
              after a warm-up one (the head moves, the trunk bit for bit);
 21. hoi     kernel 1 at the PNR crop (256 frames of 225^2 raw pixels,
              conv 113^2, pool 57^2) against its plain version, f32 and
              bf16, with times and bound; then at pnr_train's defaults
              (batch 16, 16 frames, crop 225, ``slow_layer5``, depth 50,
              raw [0, 255] frames) ``KeyframeLocalizationResNet`` (with
              dot_product Nonlocals after res3 and res4 block 1; logits
              (16, 16), tokens (16, 16, 8192)), ``StateChangeClsResNet``
              (``no_temp_pool`` off and on), ``DualHeadResNet`` and
              ``KeyframeCnnLSTM`` (one 2D stem
              launch a forward, for its 256 frames): feeds agreeing, the
              first 4 clips and the tokens against the port's CPU forward,
              the PNR metrics of those clips equal, ms a batch, clips/s,
              peak memory and the device's busy share.

then HOI Stage-II inference:
 22. hoi_ts  ts_pnr and ts_oscc (``TaskFusionMFTransformer3TaskDropout`` at
              configs/pnr/ts_{pnr,oscc}.yaml's widths: D 128, 6 layers, 16
              logits; D 256, 5 layers, 2 logits) at tools/bench_hoi.py's
              geometry (batch 8, 16 raw frames of 225^2, SlowFast-R50
              pathways of 8 + 32 frames at 224^2, alpha 4: 48 tokens), f32
              with TF32 off and bf16, the PNR and OSCC stems' BNs fitted by
              precise BN; then ``MultiTaskSlowFast`` at the AR task's build
              (alpha 8, 8 clips of 32 frames). No kernel of the port on this
              path (0 launches, exact); finite outputs of the expected
              shapes, uint8 feed equal to f32, clip 0 against the port's CPU
              forward (f32), bf16 logits within 1 - cosine 1e-3 and max
              |delta| 0.075 of f32's; ms a batch, clips/s, peak memory and
              the busy share.

Then one JSON line of every kernel (with its launches on each training
path, each Stage-I validation forward, each EgoT2-g path, the CLI's
epoch, the TTM baselines' and HOI's paths, HOI Stage II's; kernel 1's row
also at 225^2),
and as the last line
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
import os
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
# f32 kernel on raw 0-255 frames vs the plain version in f64: KERNEL_TOL
# plus this share of each output's sum of term magnitudes (3xFP16 keeps 22
# bits of each product; the f32 sums lose about as much again). Measured
# on an H100 at 256 frames of 225^2: the kernel 4.3e-4 at most, cuDNN's
# f32 conv 4.0-4.2e-4 (15 outputs over the bare 1e-4); the sums reach
# ~2,300 a window, so the bar adds up to ~2.2e-3
F32_TERM_TOL = 2.0 ** -20
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
SOURCES = ("stem_pool", "flash_attention",
           "jpeg")   # egot2x_torch/csrc/<name>.cu
# flash kernel shapes (name, BH, N, S, D): TalkNet's attention on one track
# of 2048 frames (8 heads; cross A<->V d 128, self-AV d 256) and the JAX
# oracle's odd shape (tests/test_pallas_attention.py)
FLASH_SHAPES = [("cross", 8, 2048, 2048, 16), ("self_av", 8, 2048, 2048, 32),
                ("oracle", 2, 257, 130, 40),
                ("wide", 2, 2048, 2048, 256),   # D > 128: the chunked body
                # the EgoT2-g prompt encoder on one 700-frame ASD track
                # (3 x 700 tokens, 4 heads of 256 / 4)
                ("prompt", 4, 3 * 700, 3 * 700, 64)]
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
# stem backward vs its plain version on the same saved tensors: dy to 1e-5
# of its largest value (at most 4 terms a position, summed in another
# order); dscale, dbias to 1e-5 of the sum of their terms' magnitudes (the
# blocks' partial sums in another order)
BWD_DY_RTOL = 1e-5
BWD_SUM_RTOL = 1e-5
# the training forward's winners: at least this share equal to
# F.max_pool2d's on the plain map in the output's type (bf16: rounded),
# and every other one at a near-tie (its plain value within the kernel's
# output tolerance of the window's max)
WINNER_SHARE = 0.999
# the differentiable stem's dscale and dbias vs autograd of the plain
# version, per channel to this share of the sum of their terms'
# magnitudes (random dp cancels in the sums; a winner that flips at a
# near-tie moves a term to a near-equal value, a ReLU input at the kink
# one term in or out): f32; bf16 against the plain version in f32 on the
# bf16 frames (the kernel's output, and its winners, are bf16-rounded
# values); its dW and dx vs the library's conv gradients of the plain
# backward on the same winners, by relative norm (dy to BWD_DY_RTOL;
# bf16: dx is rounded to bf16, and where the two dy differ in the last
# f32 bit its rounding may differ by one bf16 ulp, 2^-8)
STEM_GRAD_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
STEM_CONV_GRAD_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
# trainable-trunk training (train_full, asd2_train)
FULL_CLIPS = 16                    # 16 clips x 30 frames, f32: it fits
ASD_TRAIN_TRACKS = 4               # 4 tracks x 150 frames with RGB at 224^2
ASD_TRAIN_STEPS = 2
# card vs CPU train step with trainable trunks: loss 1e-4 relative, each
# gradient leaf within 5e-2 of its norm and at cosine >= 0.999 (the kernel
# and the CPU round the stem's conv apart, so pool windows whose two
# largest values nearly tie pick another winner on each device, and a
# ReLU input within f32 rounding of 0 can fall on either side of the kink:
# each moves one term of a leaf's sum; a gradient routed wrong is off by
# O(1)); leaves whose gradient is below 1e-6 per element's root (0 in
# exact arithmetic: the attention key biases) by that absolute gap
FULL_LOSS_RTOL = 1e-4
FULL_GRAD_RTOL = 5e-2
FULL_GRAD_COSINE = 0.999
# Stage-I training (stage1_*), at the CLIs' full widths: run_lam's 64 clips
# x 7 frames of 224^2 (egot2x/cli/run_lam.py:28-46); run_ttm's 400-frame
# budget as a bucket of 26 x 15 frames and one of 2 x 150
# (egot2x/cli/run_ttm.py:24-29), raw audio T / 30 s at 16 kHz; run_asd's
# 2500-frame budget as 16 tracks x 150 faces of 112^2 with MFCC
# (egot2x/cli/run_asd.py:20-24). Card vs CPU on 2 clips or tracks with
# dropout off, from the seeded state: the card's step in f64 against the
# CPU's f64 step at the train_full bars leaf by leaf, loss and BN running
# statistics 1e-4 relative (statistics to each layer's largest); the
# card's f32 step against the f64 one at the same loss, statistics and
# cosine bars and by the whole gradient's norm. No f32 step can be held to
# the f64 one leaf by leaf: with every BN on batch statistics, a near-tie
# or a leaf whose gradient nearly cancels (a PReLU scalar, an SE block's
# 2-unit bias) lands ~1e-1 off on either device (PERF.md)
LAM_CLIPS, LAM_FRAMES = 64, 7
LAM_WEIGHTS = [0.136, 0.864]
TTM_BUCKETS = ((26, 15), (2, 150))
STAGE1_STATS_RTOL = 1e-4
STAGE1_CHECK_RUNS = 4   # card steps a check: 2 default cuDNN, 2 deterministic
# EgoT2-g HHI (egot2g) at run_multitask's widths (egot2x/cli/run_multitask
# .py:20-40): hidden 256, 4 heads, 3 layers, FFN 2048, dropout 0.1, Adam lr
# 1e-4; one combined batch of LAM lam_batch 4 clips x 7 frames and TTM and
# ASD 2 clips or tracks of the mt_frames bucket, 15 frames, RGB at 224^2
# (egot2x_torch/tools/profile_egot2g.py's config() and combined_batches());
# ASD predict on one track of 700 frames, whose 3 x 700 prompt tokens take
# the flash route (>= 2048; TalkNet's 700 stay below it)
MT_TASKS = {"Unified3TaskTranslation": "TaskTranslationPromptTransformer",
            "Unified3Task": "TaskPromptTransformer"}
# stem launches of one encoding of the combined batch (2D, 3D): the
# translation model runs LAM for lam, and LAM, TTM and TalkNet for ttm and
# for asd; the baseline one trunk a task
MT_STEMS = {"Unified3TaskTranslation": (5, 2), "Unified3Task": (2, 1)}
# card vs CPU train step: f32 (TF32 off) and the int8 bars of ROADMAP.md
# §3 item 3 (the JAX package's full-translator int8 gate: cosine > 0.99)
TRAIN_LOSS_RTOL = {False: 1e-4, True: 1e-2}
TRAIN_GRAD_COSINE = {False: 0.99999, True: 0.99}
# the data plane (data, cli): frames of 512^2 with face boxes of 256^2
# (the TTM fixture at img_size 256), cropped and resized to 224^2; one
# crop_resize launch of the 150-frame bucket's item; the loader rate over
# 64 frames in items of 16
FACE, CROP_N, RATE_FRAMES, RATE_ITEM = 256, 150, 64, 16
FULL_CHROMA = "ref_3"   # egot2x_torch/tools/make_jpeg_refs.py's 4:4:4 file
# nvJPEG's decode vs libjpeg's (cv2) of the same file. With full-size
# chroma (4:4:4) the two differ only by the IDCT's rounding (IEEE 1180:
# at most 1 a sample) carried through the YCbCr -> RGB conversion (Cb
# weighs 1.772 in B) and its own rounding: at most 3 levels a channel.
# With 4:2:0, JFIF leaves the chroma upsampling to the decoder, and the
# two differ at colour edges (printed); the luma of the RGB (BT.601,
# cv2's grey weights) takes no chroma, so the decode's luma is held at a
# mean of 1 level. The chroma is held where the upsampling filter hardly
# shows: Cb and Cr of the RGB averaged over each 2x2 block (one 4:2:0
# chroma sample's footprint), within a mean of 3 levels of libjpeg's on
# every file (measured on an H100: 0.87-1.45 at 4:2:0, 0.14 at 4:4:4;
# the decode with Cb and Cr swapped reads 64.8-69.4, with neutral chroma
# 43.0-45.0, so the check must also fail the swapped decode). An nvJPEG
# encode (q95, 4:2:0) and decode of a reference: mean luma error at most
# 2 levels (q95's quantization), block chroma at most 3 (measured
# 1.05-1.50)
JPEG_444_MAX, JPEG_LUMA_MEAN, JPEG_ROUND_TRIP_LUMA = 3, 1.0, 2.0
JPEG_CHROMA_MEAN = 3.0
# the TTM baselines (ttm_baselines) at run_ttm --two_loader's widths
# (egot2x/cli/run_ttm.py:19-62: hidden_dim 256, and hidden_dim2 512, which
# the JAX task never passes, so the models' default) on one request of
# B clips x T frames; the stem launches of one forward (2D, 3D)
TTM_BASELINES = {"FinetuneTTM": (1, 0), "LAM2TTM": (1, 0), "ASD2TTM": (0, 1),
                 "TaskFusionLFLinear3Task": (2, 1)}
TTM_HIDDEN, TTM_HIDDEN2 = 256, 512
# HOI Stage-I inference (hoi) at pnr_train's defaults (egot2x/cli/
# pnr_train.py:36-44: batch 16, clip_len_sec 8 x sampling_fps 2 = 16
# frames, crop 225, slow_layer5, depth 50), full width and depth, raw
# [0, 255] frames; the keyframe model with a dot_product Nonlocal after
# res3 and res4 block 1 (where PySlowFast puts them: after res2, 57^2 x 16
# positions against a quarter of them, the affinity alone would take 43 GB
# at batch 16). The CPU answers the first PNR_CPU_CLIPS clips:
# clip 0's outputs, and the PNR metrics over those clips, against the
# card's. The random weights' stem BN (and dot_product Nonlocal BN)
# statistics are fitted to a calibration batch by precise BN (a trained
# model's match its raw-pixel inputs; with the drawn ones, near (0, 1),
# activations grow without bound: tests/test_torch_port_resnet3d.py)
PNR_CLIPS, PNR_FRAMES, PNR_CROP = 16, 16, 225
PNR_CPU_CLIPS = 4
PNR_REPEATS = 3
PNR_NONLOCAL = [[[]], [[1]], [[1]], [[]]]
TOKEN_TOL = 1e-4   # the 8192-d tokens, card vs CPU, of each token's norm
# HOI Stage-II inference (hoi_ts): the ts_pnr and ts_oscc translators at
# their configs' widths (configs/pnr/ts_{pnr,oscc}.yaml: D 128, 6 layers,
# 16 keyframe logits; D 256, 5 layers, 2 state logits) at
# tools/bench_hoi.py's geometry: batch 8, 16 raw [0, 255] frames of 225^2
# for the PNR and OSCC ResNet3D-50s, SlowFast-R50 pathways of 8 slow and
# 32 fast frames at 224^2 (alpha 4, beta_inv 8): 48 tokens. f32 with TF32
# off and bf16 (bench_hoi's QUANT=0 dtype), the same weights (the bf16
# model loads the f32 one's state). The PNR and OSCC stems' BN statistics
# are fitted to a calibration batch by precise BN (the hoi phase says
# why). Then one MultiTaskSlowFast forward at the AR task's build
# (egot2x/tasks/ar.py: depth 50, alpha 8, (115, 478) classes) on 8 clips of
# 32 frames at 224^2.
HOI_TS_CLIPS, HOI_TS_FAST, HOI_TS_IMG, HOI_TS_ALPHA = 8, 32, 224, 4
HOI_TS_MODELS = {
    "ts_pnr": dict(target="keyframe", feature_dim=128, num_layers=6),
    "ts_oscc": dict(target="state", feature_dim=256, num_layers=5)}
HOI_TS_REPEATS = 3
AR_ALPHA, AR_CLASSES = 8, (115, 478)
# bf16 against f32 logits over the batch: 1 - cosine <= 1e-3 and max
# |delta| <= 0.075, set from the card's readings at these seeds (1 - cosine
# 5.6e-5 and 2.4e-6, max |delta| 0.024 and 0.015 for ts_pnr and ts_oscc),
# ~18x and ~3x above the worse. They catch a gross dtype fault (a lost
# cast, an overflow, a trunk in the wrong dtype); a rounding in the wrong
# place (the encoder's first residual sum in bf16, say) moves the logits
# by less than bf16 itself does, and the CPU tests hold the dtype at each
# LayerNorm and projection to the JAX package's instead
# (tests/test_torch_port_hoi_translators.py)
HOI_TS_BF16_ONE_MINUS_COSINE, HOI_TS_BF16_MAX_ABS = 1e-3, 0.075


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
    m = re.search(r"stem_pool_backward_kernelI(f|13__nv_bfloat16)E", mangled)
    if m:
        return (f"stem_pool_backward_kernel<"
                f"{'f32' if m.group(1) == 'f' else 'bf16'}>")
    if "stem_pool_backward_sum_kernel" in mangled:
        return "stem_pool_backward_sum_kernel"
    if "crop_resize_kernel" in mangled:
        return "crop_resize_kernel"
    m = re.search(r"stem_pool_tc_kernelILi(\d+)ELi\d+ELi(\d+)ELb([01])E"
                  r"(f|13__nv_bfloat16|a)Lb([01])E", mangled)
    if not m:
        return mangled
    kt, ng, f32_in, out, train = m.groups()
    out = {"f": "f32", "a": "int8"}.get(out, "bf16")
    return (f"stem_pool_tc_kernel<{'f32' if f32_in == '1' else 'bf16'}->"
            f"{out},{'2d' if kt == '1' else '3d'},n{ng}"
            f"{',train' if train == '1' else ''}>")


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
                for d in (16, 32, 40, 64, 128, 256)},
            "jpeg": 0}   # crop_resize reads its taps through L1
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

    results = {}
    for kind in ("2d", "3d"):
        w, scale, bias = _stem_params(kind)
        for dtype in ("float32", "bfloat16"):
            row = _float_stem_row(kind, _stem_frames(kind, dtype), w, scale,
                                  bias)
            results[row["kernel"], dtype] = row
    return results


def _term_magnitude(x, w, scale):
    """Per pooled output of the 2D stem, the largest sum of its conv's
    terms' magnitudes over its 3x3 window, times |BN scale|: what an f32
    conv's rounding is proportional to (max-pool passes on at most the
    largest error of its window)."""
    import torch.nn.functional as F

    m = F.conv2d(x.double().abs().permute(0, 3, 1, 2), w.double().abs(),
                 stride=2, padding=3) * scale.double().abs()[:, None, None]
    return F.max_pool2d(m, 3, 2, 1).permute(0, 2, 3, 1)


def _float_stem_row(kind, x, w, scale, bias, name="kernel", f64=False,
                    **fields):
    """One float stem kernel on ``x`` against its plain version: its row
    (error, times, bound), printed as phase ``name``; fails if they
    disagree. ``f64`` (2D, raw 0-255 frames): f32 input is held against
    the plain version in float64, as tests/test_torch_port_cuda.py holds
    raw frames, at KERNEL_TOL plus F32_TERM_TOL of each output's sum of
    term magnitudes (``_term_magnitude``): on raw frames those sums are
    ~1,200, ~100x a normalised frame's, and the library's own f32 conv
    misses the bare 1e-4 there (its error is printed beside); bf16 input
    against the f32 plain version."""
    import torch

    from egot2x_torch.ops import stem

    kernel, plain = ((stem.stem_pool_2d, stem.stem_pool_2d_plain)
                     if kind == "2d" else
                     (stem.stem_pool_3d, stem.stem_pool_3d_plain))
    dtype = str(x.dtype).split(".")[1]
    out = kernel(x, w, scale, bias)
    torch.cuda.synchronize()
    tol = KERNEL_TOL[dtype]
    slack = 0.0
    if f64 and dtype == "float32":
        ref = plain(x.double(), w.double(), scale.double(), bias.double())
        slack = F32_TERM_TOL * _term_magnitude(x, w, scale)
        lib = (plain(x, w, scale, bias).double() - ref).abs()
        fields.update(
            reference="plain version in float64",
            term_tol=F32_TERM_TOL, max_term_magnitude=float(slack.max()
                                                            / F32_TERM_TOL),
            plain_f32_max_abs_err=float(lib.max()),
            plain_f32_outputs_over_kernel_tol=int(
                (lib > tol + tol * ref.abs()).sum()))
        del lib
    else:
        ref = plain(x.float(), w, scale, bias)
    err = (out.float() - ref).abs()
    ok = bool((err <= tol + tol * ref.abs() + slack).all())
    del slack
    row = dict(
        kernel=f"stem_pool_{kind}", dtype=dtype, **fields,
        shape=list(x.shape), out_shape=list(out.shape),
        max_abs_err=float(err.max()), tol=tol, ok=ok,
        ms=time_ms(lambda: kernel(x, w, scale, bias)),
        plain_ms=time_ms(lambda: plain(x, w, scale, bias)),
        library_ms=time_ms(_library_call(kind, x, w, scale, bias)))
    (row["bound_ms"], row["bound_by"], row["flops"],
     row["bytes"]) = _bound(kind, x, out)
    row.update(_design("stem_pool", dtype, row["flops"]))
    phase(name, **row)
    if not ok:
        fail(f"stem_pool_{kind} {dtype} {list(x.shape)} disagrees with its "
             f"plain version: max abs err {row['max_abs_err']}")
    del x, out, ref, err
    torch.cuda.empty_cache()
    return row


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


def _stem_grads(kind, x, w, scale, bias, dp, fn):
    """Gradients of (x, weight, scale, bias) through ``fn``."""
    import torch

    ins = [v.detach().clone().requires_grad_() for v in (x, w, scale, bias)]
    return torch.autograd.grad(fn(*ins), ins, dp)


def _library_train(kind, x, w, bn, dp):
    """The yardstick of the differentiable stem, used nowhere in the port:
    autograd of cuDNN's conv, eval BN, ReLU and max-pool, forward and
    backward to the weight and the BN's scale and offset."""
    import torch
    import torch.nn.functional as F

    params = [v.detach().clone().requires_grad_() for v in (w, bn[0], bn[1])]
    mean, var, eps = bn[2], bn[3], bn[4]

    def run():
        wt, gamma, beta = params
        if kind == "2d":
            y = F.conv2d(x.permute(0, 3, 1, 2), wt.to(x.dtype), None, 2, 3)
        else:
            b, t = x.shape[:2]
            y = F.conv3d(x.unsqueeze(1), wt.to(x.dtype), None, (1, 2, 2),
                         (2, 3, 3)).transpose(1, 2).flatten(0, 1)
        y = F.batch_norm(y, mean, var, gamma, beta, False, 0.0, eps)
        out = F.max_pool2d(torch.relu(y), 3, 2, 1)
        torch.autograd.grad(out, params, dp.permute(0, 3, 1, 2))
    return run


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def stem_bwd_phase():
    """The float stem's training variant and its backward kernel against
    their plain versions on the card, at the training paths' shapes (2D
    at 480 frames of 224^2, 3D at 16 x 30 x 112^2), f32 and bf16: the
    winners agree with ``F.max_pool2d``'s outside near-ties (counted), the
    backward kernel's dy and sums agree with the plain backward on the
    same saved tensors, and the whole differentiable stem's gradients
    (x, weight, scale, bias) agree with autograd of the plain version.
    Times: the training forward, the backward kernel, the library's
    weight gradient, the whole stem forward and backward, the plain
    version's autograd and the library yardstick. Returns the backward
    rows per (kind, dtype)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from egot2x_torch.ops import stem

    rows = {}
    for kind in ("2d", "3d"):
        code = 2 if kind == "2d" else 3
        w, scale, bias = _stem_params(kind)
        # the yardstick's eval BN: zero mean and unit variance, scale and
        # offset chosen so that it computes x scale + bias, as the stem
        bn = (scale * float(np.sqrt(1.0 + 1e-5)), bias,
              torch.zeros(64, device="cuda"), torch.ones(64, device="cuda"),
              1e-5)
        for dtype in ("float32", "bfloat16"):
            x = _stem_frames(kind, dtype)
            w_taps, b, t, h, wd = stem._float_geometry(code, x, w)
            train = lambda: stem._launch(code, x, w_taps, scale, bias, b, t,
                                         h, wd, train=True)
            out, win, yw = train()
            torch.cuda.synchronize()
            hw = (stem.conv_size(h), stem.conv_size(wd))
            # the plain map and its winners
            if kind == "2d":
                y = F.conv2d(x.float().permute(0, 3, 1, 2), w, stride=2,
                             padding=3)
            else:
                y = stem._conv3d_frames(x.float(), w)
            # the kernel takes its winners among values in the output's
            # type: bf16 ties are the plain map's rounded to bf16
            z = stem._affine_relu(y, scale, bias).to(out.dtype).float()
            del y
            p_ref, idx = F.max_pool2d(z, 3, 2, 1, return_indices=True)
            ho, wo = p_ref.shape[-2:]
            k = win.permute(0, 3, 1, 2).long()
            po = torch.arange(ho, device="cuda").view(ho, 1)
            pc = torch.arange(wo, device="cuda").view(1, wo)
            idx_k = (2 * po - 1 + k // 3) * hw[1] + 2 * pc - 1 + k % 3
            differ = idx_k != idx
            at_kernel = z.flatten(2).gather(2, idx_k.flatten(2)).view(
                p_ref.shape)
            tol = KERNEL_TOL[dtype]
            near = ((at_kernel - p_ref).abs()
                    <= tol * (1 + p_ref.abs())) | ~differ
            n_differ = int(differ.sum())
            not_near = int((~near).sum())
            out_err = float((out.float().permute(0, 3, 1, 2) - p_ref)
                            .abs().max())
            del z, at_kernel, idx, idx_k, k, near
            # the backward kernel vs the plain backward, same saved tensors
            rng = np.random.default_rng(SEED + 8)
            dp = torch.from_numpy(rng.standard_normal(
                tuple(out.shape), dtype=np.float32)).cuda().to(out.dtype)
            dy, dscale, dbias = stem.stem_pool_backward(dp, out, win, yw,
                                                        scale, hw)
            want = stem.stem_pool_backward_plain(dp, out, win, yw, scale, hw)
            want_dy = want[0]
            g = torch.where(out > 0, dp.float(), 0.0)
            dy_err = float((dy - want[0]).abs().max())
            dy_bound = BWD_DY_RTOL * float(want[0].abs().max())
            terms_scale = (g * yw).abs().sum((0, 1, 2)) + 1e-30
            terms_bias = g.abs().sum((0, 1, 2)) + 1e-30
            sum_ok = all(bool(((got - ref).abs() <= BWD_SUM_RTOL * m).all())
                         for got, ref, m in ((dscale, want[1], terms_scale),
                                             (dbias, want[2], terms_bias)))
            sum_err = max(float((dscale - want[1]).abs().max()),
                          float((dbias - want[2]).abs().max()))
            del want, g
            # the whole differentiable stem: dscale and dbias against
            # autograd of the plain version (a winner flipped at a near-tie
            # moves its term to a near-equal value, which they do not see);
            # dx and dW against the library's conv gradients of the plain
            # backward's dy on the same winners (such a flip moves a term
            # to another input patch: reported, beside, against autograd)
            fn = stem.stem_pool_2d if kind == "2d" else stem.stem_pool_3d
            plain = (stem.stem_pool_2d_plain if kind == "2d"
                     else stem.stem_pool_3d_plain)
            ours = _stem_grads(kind, x, w, scale, bias, dp, fn)
            ref = _stem_grads(kind, x.float(), w, scale, bias, dp.float(),
                              plain)
            same_winners = stem._conv_grads(code, x, w, want_dy, True, True)
            # the sums per channel, to a share of their terms' magnitudes
            # (random dp cancels in them)
            mags = (terms_scale, terms_bias)
            grad_err = {"dx": _rel(ours[0], same_winners[0]),
                        "dW": _rel(ours[1], same_winners[1]),
                        **{n: float(((a - r).abs() / m).max()) for n, a, r, m
                           in zip(("dscale", "dbias"), ours[2:], ref[2:],
                                  mags)}}
            grad_vs_autograd = {n: _rel(a, r) for n, a, r in zip(
                ("dx", "dW"), ours, ref)}
            del ours, ref, same_winners, want_dy, terms_scale, terms_bias
            torch.cuda.empty_cache()
            wgrad = lambda: stem._conv_grads(code, x, w, dy, False, True)
            w_rg, s_rg, b_rg = (v.detach().clone().requires_grad_()
                                for v in (w, scale, bias))
            whole = lambda: torch.autograd.grad(
                fn(x, w_rg, s_rg, b_rg), (w_rg, s_rg, b_rg), dp)
            plain_whole = lambda: torch.autograd.grad(
                plain(x, w_rg, s_rg, b_rg), (w_rg, s_rg, b_rg), dp)
            row = dict(
                kernel="stem_pool_backward", stem=kind, dtype=dtype,
                shape=list(x.shape), pooled=list(out.shape),
                conv_map=[out.shape[0], *hw, 64],
                winners_differ=n_differ,
                winners_differ_share=n_differ / win.numel(),
                winners_differ_not_near_tie=not_near,
                train_forward_out_max_abs_err=out_err,
                max_abs_err=dy_err, dy_bound=dy_bound,
                sums_max_abs_err=sum_err, sums_ok=sum_ok,
                grad_rel_err=grad_err, grad_rtol=STEM_GRAD_RTOL[dtype],
                dx_dW_rel_err_vs_plain_autograd=grad_vs_autograd,
                train_forward_ms=time_ms(train),
                ms=time_ms(lambda: stem.stem_pool_backward(
                    dp, out, win, yw, scale, hw)),
                plain_ms=time_ms(lambda: stem.stem_pool_backward_plain(
                    dp, out, win, yw, scale, hw), iters=3),
                library_ms=None,
                weight_grad_library_ms=time_ms(wgrad),
                stem_train_ms=time_ms(whole),
                plain_autograd_ms=time_ms(plain_whole, iters=3),
                library_yardstick_ms=time_ms(_library_train(
                    kind, x, w, bn, dp), iters=3))
            row["saved_bytes"] = (out.numel() * out.element_size()
                                  + win.numel() + yw.numel() * 4)
            row["plain_saved_map_bytes"] = out.shape[0] * 64 * hw[0] * hw[1] * 4
            (row["bound_ms"], row["bound_by"], row["bytes"],
             row["flops"]) = _bwd_bound(dp, out, dy)
            (row["train_forward_bound_ms"], _, _, _) = _bound(
                kind, x, out)
            phase("stem_bwd", **row)
            if not_near or n_differ > (1 - WINNER_SHARE) * win.numel():
                fail(f"stem_pool_{kind} {dtype} training winners: "
                     f"{n_differ} differ, {not_near} not at a near-tie")
            if out_err > tol * (1 + float(p_ref.abs().max())):
                fail(f"stem_pool_{kind} {dtype} training output off by "
                     f"{out_err}")
            if dy_err > dy_bound or not sum_ok:
                fail(f"stem_pool_backward {kind} {dtype} disagrees with its "
                     f"plain version: dy {dy_err}, sums {sum_err}")
            if (max(grad_err["dscale"], grad_err["dbias"])
                    > STEM_GRAD_RTOL[dtype]
                    or max(grad_err["dx"], grad_err["dW"])
                    > STEM_CONV_GRAD_RTOL[dtype]):
                fail(f"stem {kind} {dtype} gradients off: {grad_err}")
            rows[kind, dtype] = row
            del x, out, win, yw, dp, dy, p_ref, w_rg, s_rg, b_rg
            torch.cuda.empty_cache()
    return rows


def _bwd_bound(dp, out, dy):
    """Least time of one backward launch: its bytes (dp, p, the winners,
    their values and the scale read once, dy and the sums written once)
    at HBM bandwidth, or its operations (a compare-and-add per window
    position a pre-pool value gathers, a scale, and the two sums' adds and
    multiply per pooled value) at the f32 CUDA cores' rate; returns (ms,
    what bounds it, bytes, operations)."""
    nbytes = (dp.numel() * dp.element_size() + out.numel()
              * out.element_size() + out.numel() * (1 + 4) + 64 * 4
              + dy.numel() * 4 + 2 * 64 * 4)
    flops = 4.0 * dy.numel() + 3.0 * dp.numel()
    t_ops, t_bytes = flops / F32_CUDA_CORE_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", nbytes, flops)


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
                replaces="egot2x/ops/pallas_attention.py:93", dtype="float32",
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
    from egot2x_torch.data import image
    from egot2x_torch.ops import flash, int8, stem

    return {"crop_resize": image.crop_resize,
            "stem_pool_2d": stem.stem_pool_2d,
            "stem_pool_3d": stem.stem_pool_3d,
            "stem_pool_backward": stem.stem_pool_backward,
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

    from egot2x_torch.core.config import Config
    from egot2x_torch.core.registry import build_model
    from egot2x_torch.tasks.asd import ActiveSpeakerDetection

    task = ActiveSpeakerDetection(Config(model="TalkNetWithHeads", lr=1e-4))
    state = task.build_state(SEED)   # the seeded weights through the bridge
    model = state.model
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
            got_eval = task.eval_step(state, batch)
            with _plain_attention(), torch.no_grad():
                want = model(batch["mfcc"], batch["faces"])
                want_eval = task.eval_step(state, batch)
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


def _check_slice(batch, f64=False, cpu=False):
    """The tensors of ``batch`` (of each task's batch, for a multi-task
    ``{task: batch}``) on its first TRAIN_CHECK_CLIPS clips; on the CPU
    with ``cpu``, and there floats in f64 with ``f64``."""
    import torch

    if all(isinstance(v, dict) for v in batch.values()):
        return {k: _check_slice(v, f64, cpu) for k, v in batch.items()}
    out = {k: v[:TRAIN_CHECK_CLIPS] for k, v in batch.items()
           if isinstance(v, torch.Tensor)}
    if cpu:
        out = {k: v.cpu() for k, v in out.items()}
    if f64:
        out = {k: v.double() if v.is_floating_point() else v
               for k, v in out.items()}
    return out


def _twin(task, state, f64=False, device="cpu"):
    """A task of ``task``'s kind and configuration on ``device`` holding
    the card model's state (weights, statistics and int8 scales), dropout
    off, and its train state. ``f64``: the model computes in f64
    (parameters and compute dtype; the loss in f32, as the task computes
    it), the exact step the card's f32 step is held to."""
    import torch

    twin = type(task)(task.cfg, device=device)
    twin_state = twin.build_state(SEED)
    twin.model.load_state_dict(
        {k: v.to(device) for k, v in state.model.state_dict().items()})
    if f64:
        twin.model.double()
        for m in twin.model.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float64
    _no_dropout(twin.model)
    return twin, twin_state


def _grads(model, cpu=False):
    return {n: p.grad.cpu() if cpu else p.grad
            for n, p in model.named_parameters() if p.grad is not None}


def _card_cpu_step(task, state, batch):
    """One train step with dropout off on the first TRAIN_CHECK_CLIPS clips
    of ``batch``, on the card and on the CPU from the card model's state,
    through a CPU task of the same kind and configuration. Returns (card
    loss, CPU loss, card gradients, CPU gradients, seconds of the CPU
    step)."""
    import torch

    small = _check_slice(batch)
    cpu_task, cpu_state = _twin(task, state)
    _no_dropout(state.model)
    state, card = task.train_step(state, small, torch.Generator("cuda"))
    t0 = time.perf_counter()
    cpu_state, cpu = cpu_task.train_step(
        cpu_state, _check_slice(batch, cpu=True), torch.Generator())
    cpu_s = time.perf_counter() - t0
    grads, cpu_grads = _grads(state.model, cpu=True), _grads(cpu_task.model)
    if sorted(grads) != sorted(cpu_grads):
        fail(f"train check: gradient leaves differ, {sorted(grads)[:5]} vs "
             f"{sorted(cpu_grads)[:5]}")
    return float(card["loss"]), float(cpu["loss"]), grads, cpu_grads, cpu_s


def _running_stats(model):
    return {k: v.detach().clone() for k, v in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def _stats_gap(model, cpu_model):
    """The largest gap of a BN running statistic between the card's model
    and the CPU's, relative to that statistic's largest magnitude in its
    layer."""
    cpu = _running_stats(cpu_model)
    return max((float((v.cpu() - cpu[k]).abs().max())
                / max(float(cpu[k].abs().max()), 1e-30)
                for k, v in _running_stats(model).items()), default=0.0)


def _train_check(task, state, batch):
    """The card vs CPU step of frozen training: (loss relative error,
    least gradient cosine over the translator's leaves, that leaf, card
    loss, CPU loss)."""
    card, want, grads, cpu_grads, _ = _card_cpu_step(task, state, batch)
    cosines = {n: _cosine(grads[n], cpu_grads[n]) for n in grads}
    worst = min(cosines, key=cosines.get)
    return abs(card - want) / abs(want), cosines[worst], worst, card, want


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
    state, losses, seconds, peak_gib, counts = _train_steps(
        task, state, batches, generator)
    per_step = (dict(stem_pool_q_2d=2, stem_pool_q_3d=1,
                     int8_conv2d=CONVS_PER_FORWARD) if quant
                else dict(stem_pool_2d=2, stem_pool_3d=1))
    expect = _expected(TRAIN_STEPS + 1, **per_step)
    moved, dead, changed = _check_trained(name, model, before, frozen,
                                          losses, counts, expect)
    ctx = task.start_validation()
    task.accumulate(ctx, task.eval_step(state, batches[-1]), batches[-1])
    val = task.finalize_validation(ctx)
    phase(name, card=card, model="TaskFusionMFTransformer3Task",
          task="TalkingToMe2Loader", quant_trunks=quant,
          dtype="bfloat16" if quant else "float32", hidden=HIDDEN,
          layers=LAYERS, heads=HEADS, clips=B, frames=T, steps=TRAIN_STEPS,
          clips_per_s=TRAIN_STEPS * B / seconds,
          ms_per_step=seconds / TRAIN_STEPS * 1e3, peak_mem_gib=peak_gib,
          calibrate_s=calibrate_s, losses=losses, validation=val,
          translator_leaves_moved=f"{moved} of {len(before)}",
          leaves_with_zero_gradient=dead, frozen_entries_changed=changed,
          frozen_entries=len(frozen), launches=counts,
          expected_launches=expect)
    if not all(0.0 <= v <= 1.0 for v in val.values()):
        fail(f"{name}: validation {val}")
    loss_err, cosine, leaf, card_loss, cpu_loss = _train_check(
        task, state, batches[0])
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


def _grad_gaps(card, cpu):
    """(largest relative norm gap, its leaf, least cosine, its leaf) over
    the gradient leaves, and the leaves whose gap fails the bars."""
    worst = {"rel": (0.0, None), "cos": (1.0, None)}
    bad = []
    for name, g in cpu.items():
        c = card[name].double()
        g = g.double()
        floor = 1e-6 * math.sqrt(g.numel())
        gap = float((c - g).norm())
        if float(g.norm()) <= floor:
            if gap > floor:
                bad.append(name)
            continue
        rel = gap / float(g.norm())
        cos = float(c.flatten() @ g.flatten() / (c.norm() * g.norm()))
        if rel > worst["rel"][0]:
            worst["rel"] = (rel, name)
        if cos < worst["cos"][0]:
            worst["cos"] = (cos, name)
        if rel > FULL_GRAD_RTOL or cos < FULL_GRAD_COSINE:
            bad.append(name)
    return worst, bad


def _train_steps(task, state, batches, generator, warmup=1):
    """The warm-up steps (the first ``warmup`` batches) and the timed steps,
    with every launch count set to 0 just before and read just after.
    Returns (state, losses, seconds of the timed steps, peak GiB, launch
    counts)."""
    import torch

    for fn in _counters().values():
        fn.launches = 0
    losses = []
    for batch in batches[:warmup]:
        state, metrics = task.train_step(state, batch, generator)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for batch in batches[warmup:]:
        state, metrics = task.train_step(state, batch, generator)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in _counters().items()}
    return (state, [float(x) for x in losses], seconds,
            torch.cuda.max_memory_allocated() / 2**30, counts)


def _check_trained(name, model, before, stats, losses, counts, expect):
    """Launch counts as expected, finite losses, every leaf of ``before``
    moved, the state entries of ``stats`` (the trunks' BN statistics, and
    their weights when frozen) bit for bit."""
    import torch

    params = dict(model.named_parameters())
    still = [n for n in before if torch.equal(params[n].detach(), before[n])]
    # a leaf behind a ReLU that is 0 over the whole batch takes a gradient
    # of exactly 0, and Adam leaves it (as optax would): it may stay
    dead = [n for n in still if params[n].grad is not None
            and not bool(params[n].grad.any())]
    entries = model.state_dict()
    changed = [k for k, v in stats.items() if not torch.equal(entries[k], v)]
    if counts != expect:
        fail(f"{name}: launches {counts}, expected {expect}")
    if not all(map(math.isfinite, losses)):
        fail(f"{name}: losses {losses}")
    if len(still) != len(dead):
        fail(f"{name}: leaves that did not move: "
             f"{sorted(set(still) - set(dead))[:5]}")
    if changed:
        fail(f"{name}: trunk entries changed: {changed[:5]}")
    return len(before) - len(still), dead, len(changed)


def _trunk_stats(model, prefix=""):
    from egot2x_torch.translate.egot2s_hhi import FROZEN_KEYS

    return {k: v.clone() for k, v in model.named_buffers()
            if k[len(prefix):].split(".", 1)[0] in FROZEN_KEYS
            and k.startswith(prefix)}


def train_full_phase(card, remat):
    """Stage-II training of the flagship with trainable trunks
    (``nofreeze``, and with ``remat``) through the port's
    ``TalkingToMe2Loader`` at full width and depth, f32 with TF32 off: a
    warm-up and TRAIN_STEPS timed steps of FULL_CLIPS clips x 30 frames,
    launch counts a step (2 + 1 stems forward, twice under remat, and 3
    backward), finite losses, every leaf moved (but those whose gradient
    is exactly 0: a ReLU dead over the batch), the trunks' BN statistics
    bit for bit, peak memory; without remat, one step card vs CPU on 2
    clips. Returns (launch counts, the first step's loss)."""
    import torch

    from egot2x_torch.core.config import Config
    from egot2x_torch.tasks.ttm_2loader import TalkingToMe2Loader

    name = "train_full_remat" if remat else "train_full"
    cfg = Config(model="TaskFusionMFTransformer3Task",
                 weights=TTM_CLASS_WEIGHTS, lr=1e-4, wd=1e-4,
                 hidden_dim=HIDDEN, num_layers=LAYERS, num_heads=HEADS,
                 dropout=0.1, compute_dtype="float32", nofreeze=True,
                 remat=remat)
    task = TalkingToMe2Loader(cfg)
    state = task.build_state(SEED)
    model = state.model
    batches = [{k: v[:FULL_CLIPS] if hasattr(v, "shape") else v
                for k, v in b.items()}
               for b in _train_batches(TRAIN_STEPS + 1, SEED + 6)]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = _trunk_stats(model)
    generator = torch.Generator("cuda").manual_seed(SEED + 7)
    state, losses, seconds, peak_gib, counts = _train_steps(
        task, state, batches, generator)
    fwd = 2 if remat else 1
    expect = _expected(TRAIN_STEPS + 1, stem_pool_2d=2 * fwd,
                       stem_pool_3d=fwd, stem_pool_backward=3)
    moved, dead, changed = _check_trained(name, model, before, stats, losses,
                                          counts, expect)
    phase(name, card=card, model="TaskFusionMFTransformer3Task",
          task="TalkingToMe2Loader", nofreeze=True, remat=remat,
          dtype="float32", hidden=HIDDEN, layers=LAYERS, heads=HEADS,
          clips=FULL_CLIPS, frames=T, steps=TRAIN_STEPS,
          clips_per_s=TRAIN_STEPS * FULL_CLIPS / seconds,
          ms_per_step=seconds / TRAIN_STEPS * 1e3, peak_mem_gib=peak_gib,
          losses=losses, leaves_moved=f"{moved} of {len(before)}",
          leaves_with_zero_gradient=dead,
          trunk_statistics=len(stats), trunk_statistics_changed=changed,
          launches=counts, expected_launches=expect)
    if not remat:
        _full_check(task, state, batches[0])
    return counts, losses[0]


def _full_check(task, state, batch):
    """The card vs CPU step of training with trainable trunks: the loss and
    each leaf's gradient by relative norm and cosine."""
    card, want, grads, cpu_grads, cpu_s = _card_cpu_step(task, state,
                                                         batch)
    worst, bad = _grad_gaps(grads, cpu_grads)
    loss_err = abs(card - want) / abs(want)
    phase("train_full_check", vs="cpu", clips=TRAIN_CHECK_CLIPS, frames=T,
          dropout=0.0, leaves=len(grads), loss_card=card, loss_cpu=want,
          loss_rel_err=loss_err, loss_rtol=FULL_LOSS_RTOL,
          max_grad_rel_norm=worst["rel"][0], max_grad_rel_leaf=worst["rel"][1],
          min_grad_cosine=worst["cos"][0], min_grad_cosine_leaf=worst["cos"][1],
          grad_rtol=FULL_GRAD_RTOL, cosine_bar=FULL_GRAD_COSINE,
          leaves_failing=bad[:5], cpu_step_s=cpu_s)
    if not loss_err <= FULL_LOSS_RTOL:
        fail(f"train_full: card loss {card} vs CPU {want}")
    if bad:
        fail(f"train_full: gradients off the CPU's: {bad[:5]}")


def asd2_train_phase(card, nofreeze):
    """The ASD 2-loader task's training (``ActiveSpeakerDetection2Loader``
    on ``TaskFusionMFTransformer3TaskASD`` + lossAV at its defaults,
    hidden 128, 1 layer, 4 heads, dropout 0.1), frozen or ``nofreeze``,
    f32 with TF32 off, on a 150-frame bucket of ASD_TRAIN_TRACKS tracks
    with RGB at 224^2: a warm-up and ASD_TRAIN_STEPS timed steps, launch
    counts a step (2 + 1 stems forward; 3 backward with nofreeze), finite
    losses, every trainable leaf moved, the trunks' BN statistics bit for
    bit, peak memory, then one validation batch. Returns the counts."""
    import numpy as np
    import torch

    from egot2x_torch.core.config import Config
    from egot2x_torch.nn.resnet2d import normalize_u8_frames
    from egot2x_torch.tasks.asd_2loader import ActiveSpeakerDetection2Loader

    name = "asd2_train_nofreeze" if nofreeze else "asd2_train"
    task = ActiveSpeakerDetection2Loader(Config(
        model="TaskFusionMFTransformer3TaskASD", lr=1e-4, dropout=0.1,
        nofreeze=nofreeze, compute_dtype="float32"))
    state = task.build_state(SEED)
    model = state.model
    rng = np.random.default_rng(SEED + 9)
    batches = []
    for i in range(ASD_TRAIN_STEPS + 1):
        b = _asd_batch(ASD_TRAIN_TRACKS, ASD_FRAMES, SEED + 10 + i)
        rgb = rng.integers(0, 256, (ASD_TRAIN_TRACKS, ASD_FRAMES, IMG, IMG,
                                    3), dtype=np.uint8)
        batches.append(dict(
            frames=normalize_u8_frames(torch.from_numpy(rgb).cuda()),
            faces=b["faces"], mfcc=b["mfcc"], labels=b["labels"],
            audio=torch.zeros(ASD_TRAIN_TRACKS, ASD_FRAMES * 16000 // 30,
                              device="cuda")))
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    stats = _trunk_stats(model, "translator.")
    generator = torch.Generator("cuda").manual_seed(SEED + 11)
    state, losses, seconds, peak_gib, counts = _train_steps(
        task, state, batches, generator)
    expect = _expected(ASD_TRAIN_STEPS + 1, stem_pool_2d=2, stem_pool_3d=1,
                       stem_pool_backward=3 if nofreeze else 0)
    moved, dead, changed = _check_trained(name, model, before, stats, losses,
                                          counts, expect)
    ctx = task.start_validation()
    task.accumulate(ctx, task.eval_step(state, batches[-1]), batches[-1])
    val = task.finalize_validation(ctx)
    phase(name, card=card, model="TaskFusionMFTransformer3TaskASD",
          head="lossAV", task="ActiveSpeakerDetection2Loader",
          nofreeze=nofreeze, dtype="float32", tracks=ASD_TRAIN_TRACKS,
          frames=ASD_FRAMES, rgb=IMG, steps=ASD_TRAIN_STEPS,
          frames_per_s=ASD_TRAIN_STEPS * ASD_TRAIN_TRACKS * ASD_FRAMES
          / seconds, ms_per_step=seconds / ASD_TRAIN_STEPS * 1e3,
          peak_mem_gib=peak_gib, losses=losses, validation=val,
          leaves_moved=f"{moved} of {len(before)}",
          leaves_with_zero_gradient=dead,
          trunk_statistics=len(stats), trunk_statistics_changed=changed,
          launches=counts, expected_launches=expect)
    if not 0.0 <= val["val_acc"] <= 1.0:
        fail(f"{name}: validation {val}")
    return counts


def _stage1_batches(name, seed):
    """A Stage-I task's batches on the card: (warm-up and timed train
    batches, warm-up count, a validation batch). LAM: 64 clips x 7 frames;
    TTM: its two buckets, each warmed up, then 15, 150, 15 frames; ASD: 16
    tracks x 150 faces."""
    import torch

    from egot2x_torch.nn.resnet2d import normalize_u8_frames

    g = torch.Generator("cuda").manual_seed(seed)
    u8 = lambda *shape: torch.randint(0, 256, shape, generator=g,
                                      device="cuda", dtype=torch.uint8)
    labels = lambda *shape: torch.randint(0, 2, shape, generator=g,
                                          device="cuda")

    def lam(i):
        return dict(frames=normalize_u8_frames(
            u8(LAM_CLIPS, LAM_FRAMES, IMG, IMG, 3)), label=labels(LAM_CLIPS),
            uid=[f"clip{i}_{j}" for j in range(LAM_CLIPS)])

    def ttm(i, clips, frames):
        return dict(
            frames=normalize_u8_frames(u8(clips, frames, IMG, IMG, 3)),
            audio=0.1 * torch.randn(clips, frames * 16000 // 30,
                                    generator=g, device="cuda"),
            label=labels(clips), seg_id=[f"seg{i}_{j}" for j in range(clips)],
            start=[0] * clips, end=[frames] * clips)

    def asd(i):
        return _asd_batch(ASD_TRACKS, ASD_FRAMES, seed + i)

    if name == "stage1_lam":
        return [lam(i) for i in range(TRAIN_STEPS + 1)], 1, lam(-1)
    if name == "stage1_ttm":
        order = [0, 1, 0, 1, 0]     # each bucket warmed up, then 3 timed
        return ([ttm(i, *TTM_BUCKETS[k]) for i, k in enumerate(order)], 2,
                ttm(-1, *TTM_BUCKETS[0]))
    return [asd(i) for i in range(TRAIN_STEPS + 1)], 1, asd(-1)


def stage1_phase(card, name):
    """Stage-I training of a task at its CLI's full width through the port
    (``LookingAtMe`` on ``BaselineLSTM``, ``TalkingToMe`` on
    ``TTMBaselineLSTM``, ``ActiveSpeakerDetection`` on ``TalkNetWithHeads``
    with dropout 0.1 and lr decay), f32 with TF32 off: the warm-up and
    timed train steps with every launch count set to 0 just before and
    read just after (no kernel: the stems' BNs take batch statistics, as
    the JAX package's XLA stems do), finite losses, every leaf moved (but
    those whose gradient is exactly 0), every BN running statistic moved;
    then one validation batch through ``eval_step`` (one stem kernel
    launch, eval BN) held against the CPU's, and from the seeded state one
    step card vs CPU on 2 clips with dropout off (TTM: on each bucket). For
    LAM also one ``GazeLSTM`` step. Returns (train counts, validation
    counts)."""
    import torch

    from egot2x_torch.core.config import Config
    from egot2x_torch.tasks.asd import ActiveSpeakerDetection
    from egot2x_torch.tasks.lam import LookingAtMe
    from egot2x_torch.tasks.ttm import TalkingToMe

    task = {
        "stage1_lam": lambda: LookingAtMe(Config(
            model="BaselineLSTM", weights=LAM_WEIGHTS, lr=5e-4)),
        "stage1_ttm": lambda: TalkingToMe(Config(
            model="TTMBaselineLSTM", weights=TTM_CLASS_WEIGHTS, lr=5e-4)),
        "stage1_asd": lambda: ActiveSpeakerDetection(Config(
            model="TalkNetWithHeads", lr=1e-4, lr_decay=0.95)),
    }[name]()
    stem = "stem_pool_3d" if name == "stage1_asd" else "stem_pool_2d"
    state = task.build_state(SEED)
    model = state.model
    batches, warmup, val_batch = _stage1_batches(name, SEED + 13)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = _running_stats(model)
    generator = torch.Generator("cuda").manual_seed(SEED + 14)
    state, losses, seconds, peak_gib, counts = _train_steps(
        task, state, batches, generator, warmup)
    expect = _expected(len(batches))
    moved, dead, _ = _check_trained(name, model, before, {}, losses, counts,
                                    expect)
    still = [k for k, v in _running_stats(model).items()
             if torch.equal(v, stats[k])]
    if still:
        fail(f"{name}: BN running statistics that did not move: {still[:5]}")
    for fn in _counters().values():
        fn.launches = 0
    ctx = task.start_validation()
    val_out = task.eval_step(state, val_batch)
    task.accumulate(ctx, val_out, val_batch)
    val_counts = {k: fn.launches for k, fn in _counters().items()}
    val = task.finalize_validation(ctx)
    val_expect = _expected(1, **{stem: 1})
    timed = batches[warmup:]
    clips = sum(len(b["mfcc"] if "mfcc" in b else b["frames"])
                for b in timed)
    frames = sum(b["labels"].numel() if "labels" in b else
                 b["frames"].shape[0] * b["frames"].shape[1] for b in timed)
    extra = {}
    if name == "stage1_lam":
        gaze = LookingAtMe(Config(model="GazeLSTM", weights=LAM_WEIGHTS,
                                  lr=5e-4))
        gaze_state = gaze.build_state(SEED)
        for fn in _counters().values():
            fn.launches = 0
        gaze_state, metrics = gaze.train_step(gaze_state, batches[1],
                                              generator)
        extra = dict(gaze_lstm_loss=float(metrics["loss"]),
                     gaze_lstm_launches=sum(
                         fn.launches for fn in _counters().values()))
        del gaze, gaze_state
        if not math.isfinite(extra["gaze_lstm_loss"]) or \
                extra["gaze_lstm_launches"]:
            fail(f"{name}: GazeLSTM step {extra}")
    phase(name, card=card, model=type(model).__name__,
          task=type(task).__name__, dtype="float32",
          batches=[tuple(b["labels" if "labels" in b else "frames"].shape[:2])
                   for b in timed],
          steps=len(timed), clips_per_s=clips / seconds,
          frames_per_s=frames / seconds,
          ms_per_step=seconds / len(timed) * 1e3, peak_mem_gib=peak_gib,
          losses=losses, leaves_moved=f"{moved} of {len(before)}",
          leaves_with_zero_gradient=dead,
          running_statistics_moved=f"{len(stats)} of {len(stats)}",
          launches=counts, expected_launches=expect, validation=val,
          validation_launches=val_counts,
          expected_validation_launches=val_expect, **extra)
    if val_counts != val_expect:
        fail(f"{name}: validation launches {val_counts}, expected "
             f"{val_expect}")
    if not all(0.0 <= v <= 1.0 for v in val.values()):
        fail(f"{name}: validation {val}")
    twins = {"f64": _twin(task, state, f64=True),
             "f32": _twin(task, state),
             "card_f64": _twin(task, state, f64=True, device="cuda")}
    _eval_check(name, task, state, *twins["f64"], val_batch, val_out)
    # the step checks start from the seeded state, the same point in every
    # run: the timed steps' weights differ from run to run in the order
    # cuDNN's default algorithms add, and how far f32 lands from f64 on a
    # leaf depends on the point (PERF.md)
    state = task.build_state(SEED)
    _stage1_step_check(f"{name}_check", task, state, twins, batches[0])
    if name == "stage1_ttm":    # the 150-frame bucket: 5 s of audio
        _stage1_step_check(f"{name}_check_150", task, state, twins,
                           batches[1])
    return counts, val_counts


def _eval_check(name, task, state, twin, twin_state, batch, out):
    """The card's validation outputs (kernel 1 on eval BN) on the first
    TRAIN_CHECK_CLIPS clips against the same ``eval_step`` of the f64 CPU
    twin (the stems' plain version), within LOGIT_TOL (rtol = atol)."""
    import torch

    want = twin.eval_step(twin_state, _check_slice(batch, f64=True,
                                                   cpu=True))
    gaps = {}
    for k, v in want.items():
        if not v.is_floating_point():
            continue
        got = out[k][:TRAIN_CHECK_CLIPS].cpu().double()
        gaps[k] = float(((got - v).abs() / (1.0 + v.abs())).max())
    phase(f"{name}_eval_check", vs="cpu, f64", clips=TRAIN_CHECK_CLIPS,
          outputs=sorted(gaps), max_rel_err=gaps, tol=LOGIT_TOL)
    if not gaps or max(gaps.values()) > LOGIT_TOL:
        fail(f"{name}: validation outputs off the CPU's: {gaps}")


def _stage1_step_check(name, task, state, twins, batch):
    """One Stage-I train step with dropout off on the first
    TRAIN_CHECK_CLIPS clips of ``batch``, from the card model's state, in
    two parts. The card's path computes the step the CPU's does: the
    card's step in f64 against the CPU's f64 step, loss and running
    statistics within FULL_LOSS_RTOL and STAGE1_STATS_RTOL, each gradient
    leaf within FULL_GRAD_RTOL of its norm and at cosine FULL_GRAD_COSINE.
    The card's f32 step is near the exact one: STAGE1_CHECK_RUNS card f32
    steps, half with cuDNN's default algorithms (the training's) and half
    with its deterministic ones, against the f64 step at the same loss and
    statistics bars, each leaf at the cosine bar and the whole gradient
    within FULL_GRAD_RTOL of its norm. Leaf by leaf an f32 step cannot be
    held there: on a leaf whose gradient sums terms that nearly cancel (a
    PReLU's scalar, an SE block's 2-unit bias) it lands ~1e-1 off f64 on
    either device (PERF.md); the per-leaf gaps of the card's and the CPU's
    f32 steps are printed. ``twins``: the CPU's f64 and f32 tasks and the
    card's f64 one. The card's model is left at its state on entry."""
    import torch

    snapshot = {k: v.clone() for k, v in state.model.state_dict().items()}
    ref = {}
    for kind, (twin, twin_state) in twins.items():
        on_card = kind == "card_f64"
        twin.model.load_state_dict(
            {k: v if on_card else v.cpu() for k, v in snapshot.items()})
        t0 = time.perf_counter()
        _, out = twin.train_step(
            twin_state, _check_slice(batch, f64=kind != "f32",
                                     cpu=not on_card),
            torch.Generator("cuda" if on_card else "cpu"))
        if on_card:
            torch.cuda.synchronize()
        ref[kind] = dict(loss=float(out["loss"]),
                         grads=_grads(twin.model, cpu=True),
                         seconds=time.perf_counter() - t0)
    exact = ref["f64"]
    if sorted(ref["card_f64"]["grads"]) != sorted(exact["grads"]):
        fail(f"{name}: gradient leaves differ")
    worst, bad = _grad_gaps(ref["card_f64"]["grads"], exact["grads"])
    f64_check = dict(
        loss_rel_err=abs(ref["card_f64"]["loss"] - exact["loss"])
        / abs(exact["loss"]),
        stats_rel_err=_stats_gap(twins["card_f64"][0].model,
                                 twins["f64"][0].model),
        max_grad_rel_norm=worst["rel"][0], leaf=worst["rel"][1],
        min_grad_cosine=worst["cos"][0], cosine_leaf=worst["cos"][1],
        leaves_failing=bad[:5])
    worst, _ = _grad_gaps(ref["f32"]["grads"], exact["grads"])
    cpu_f32 = dict(max_grad_rel_norm=worst["rel"][0], leaf=worst["rel"][1],
                   min_grad_cosine=worst["cos"][0],
                   cosine_leaf=worst["cos"][1])
    _no_dropout(state.model)
    small = _check_slice(batch)
    runs, card_grads = [], {}
    for i in range(STAGE1_CHECK_RUNS):
        deterministic = i >= STAGE1_CHECK_RUNS // 2
        state.model.load_state_dict(snapshot)
        torch.backends.cudnn.deterministic = deterministic
        try:
            state, card = task.train_step(state, small,
                                          torch.Generator("cuda"))
        finally:
            torch.backends.cudnn.deterministic = False
        grads = _grads(state.model, cpu=True)
        card_grads.setdefault(deterministic, []).append(grads)
        worst, _ = _grad_gaps(grads, exact["grads"])
        whole = torch.cat([grads[k].double().flatten() for k in sorted(grads)])
        want = torch.cat([exact["grads"][k].double().flatten()
                          for k in sorted(grads)])
        runs.append(dict(
            deterministic=deterministic,
            loss_rel_err=abs(float(card["loss"]) - exact["loss"])
            / abs(exact["loss"]),
            stats_rel_err=_stats_gap(state.model, twins["f64"][0].model),
            grad_rel_norm=float((whole - want).norm() / want.norm()),
            max_leaf_rel_norm=worst["rel"][0], leaf=worst["rel"][1],
            min_grad_cosine=worst["cos"][0], cosine_leaf=worst["cos"][1]))
    state.model.load_state_dict(snapshot)
    spread = {}
    for deterministic, (first, *rest) in card_grads.items():
        gap = max((_grad_gaps(g, first)[0]["rel"] for g in rest),
                  default=(0.0, None))
        spread["deterministic" if deterministic else "default"] = dict(
            max_rel_norm_between_runs=gap[0], leaf=gap[1])
    phase(name, vs="cpu, f64", clips=TRAIN_CHECK_CLIPS,
          frames=tuple(small["labels" if "labels" in small else
                             "frames"].shape[:2]),
          dropout=0.0, leaves=len(exact["grads"]), loss_cpu=exact["loss"],
          loss_rtol=FULL_LOSS_RTOL, stats_rtol=STAGE1_STATS_RTOL,
          grad_rtol=FULL_GRAD_RTOL, cosine_bar=FULL_GRAD_COSINE,
          card_f64=f64_check, card_f32_runs=runs, card_f32_spread=spread,
          cpu_f32=cpu_f32,
          step_s={k: v["seconds"] for k, v in ref.items()})
    if not (f64_check["loss_rel_err"] <= FULL_LOSS_RTOL
            and f64_check["stats_rel_err"] <= STAGE1_STATS_RTOL
            and not f64_check["leaves_failing"]):
        fail(f"{name}: the card's f64 step off the CPU's: {f64_check}")
    for run in runs:
        if not (run["loss_rel_err"] <= FULL_LOSS_RTOL
                and run["stats_rel_err"] <= STAGE1_STATS_RTOL
                and run["grad_rel_norm"] <= FULL_GRAD_RTOL
                and run["min_grad_cosine"] >= FULL_GRAD_COSINE):
            fail(f"{name}: the card's f32 step off the f64 one: {run}")


def _mt_shapes(mt):
    """The combined batch's (clips, frames) of each task."""
    return dict(lam=[mt.LAM_CLIPS, mt.LAM_FRAMES], ttm=[mt.CLIPS, mt.FRAMES],
                asd=[mt.CLIPS, mt.FRAMES])


def egot2g_eval_phase(card, name, batch):
    """One EgoT2-g task's model answers the combined batch through the
    task's eval step (each task's batch encoded once, then its greedy
    step and its teacher-forced loss): a warm-up and ASD_REPEATS timed
    steps with every launch count set to 0 just before and read just
    after, finite outputs, and clip 0 of each task against ``predict`` of
    the port's CPU model with the same weights. Returns (task, state,
    launch counts)."""
    from egot2x_torch.tasks import multitask_hhi
    from egot2x_torch.tools import profile_egot2g as mt

    cfg = mt.config()
    task = getattr(multitask_hhi, name)(cfg)
    state = task.build_state(SEED)
    out, ms, peak, counts, forwards = _serve_requests(
        lambda: task.eval_step(state, batch))
    rgb, talknet = MT_STEMS[name]
    expect = _expected(forwards, stem_pool_2d=rgb, stem_pool_3d=talknet)
    phase("egot2g", card=card, task=name, model=MT_TASKS[name],
          request="eval", hidden=cfg.hidden_dim, layers=cfg.num_layers,
          heads=cfg.num_heads, **_mt_shapes(mt), rgb=mt.IMG,
          ms_per_request=ms,
          batches_per_s=1e3 / ms, peak_mem_gib=peak, launches=counts,
          expected_launches=expect)
    if counts != expect:
        fail(f"egot2g {name}: launches {counts}, expected {expect}")
    rows = {"lam": mt.LAM_CLIPS, "ttm": mt.CLIPS, "asd": mt.CLIPS * mt.FRAMES}
    for t, n in rows.items():
        _check_finite(f"egot2g {name}", {t: out[t]}, (n, 2))
        _check_finite(f"egot2g {name}", {f"{t}_loss": out[f"{t}_loss"]}, ())
    cpu = getattr(multitask_hhi, name)(task.cfg, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               state.model.state_dict().items()})
    want = {}
    for t, b in batch.items():
        clip0 = {k: v[:1].cpu() for k, v in b.items()}
        want[t] = cpu.model.predict(*cpu._task_args(t, clip0), t)
    errs = _check_close(f"egot2g {name}, clip 0 card vs CPU",
                        {t: out[t][:len(w)] for t, w in want.items()}, want)
    phase("egot2g_check", task=name, vs="cpu predict, clip 0",
          max_abs_err=errs, tol=LOGIT_TOL)
    return task, state, counts


def egot2g_long_phase(card, model):
    """ASD ``predict`` of the translation model on one 700-frame track:
    a warm-up and ASD_REPEATS timed requests, three flash launches a
    request at (4, 2100, 64) (the prompt encoder's layers), none in TalkNet
    or the decoder; the answer against the same model with its attention
    computed by the plain version. Returns the launch counts."""
    import numpy as np
    import torch

    from egot2x_torch.nn.resnet2d import normalize_u8_frames
    from egot2x_torch.ops import flash
    from egot2x_torch.tools import profile_egot2g as mt

    n, layers = mt.LONG_TRACK, mt.config().num_layers
    batch = _asd_batch(1, n, SEED + 11)
    rng = np.random.default_rng(SEED + 12)
    rgb = rng.integers(0, 256, (1, n, mt.IMG, mt.IMG, 3), dtype=np.uint8)
    args = (normalize_u8_frames(torch.from_numpy(rgb).cuda()),
            batch["faces"], torch.zeros(1, n * 16000 // 30).cuda(),
            batch["mfcc"])
    predict = lambda: model.predict(*args, "asd")
    out, ms, peak, counts, forwards = _serve_requests(predict)
    expect = _expected(forwards, stem_pool_2d=2, stem_pool_3d=1,
                       flash_attention=layers)
    shapes, kernel = [], flash.flash_attention

    def record(q, k, v):   # the kernel counts on the module's name: here
        shapes.append([q.shape[0] * q.shape[2], q.shape[1], q.shape[3]])
        return kernel(q, k, v)

    record.launches = 0
    flash.flash_attention = record
    try:
        predict()
    finally:
        flash.flash_attention = kernel
    phase("egot2g", card=card, task="Unified3TaskTranslation",
          model="TaskTranslationPromptTransformer", request="asd predict",
          tracks=1, frames=n, rgb=mt.IMG, ms_per_request=ms,
          frames_per_s=n / ms * 1e3, peak_mem_gib=peak,
          flash_shapes=shapes, launches=counts, expected_launches=expect)
    if counts != expect or shapes != [[4, 3 * n, 64]] * layers:
        fail(f"egot2g long track: launches {counts}, expected {expect}; "
             f"flash shapes {shapes}")
    _check_finite("egot2g long track", {"asd": out}, (n, 2))
    with _plain_attention():
        want = predict()
    errs = _check_close("egot2g long track, flash vs plain attention",
                        {"asd": out}, {"asd": want})
    phase("egot2g_check", request="long track",
          vs="plain attention on the card", max_abs_err=errs, tol=LOGIT_TOL)
    return counts


def egot2g_train_phase(card, task, state):
    """Frozen Stage-II training of ``Unified3TaskTranslation`` (f32, TF32
    off, dropout 0.1): a warm-up and TRAIN_STEPS timed steps on combined
    batches with every launch count set to 0 just before and read just
    after, finite losses, every core and projection leaf moved, the
    backbones' weights and statistics bit for bit; then one step with
    dropout off on TRAIN_CHECK_CLIPS clips of each task against the same
    step on the CPU. Returns the launch counts."""
    import torch

    from egot2x_torch.tools import profile_egot2g as mt
    from egot2x_torch.translate.egot2g import FROZEN_KEYS

    model = state.model
    frozen = {k: v.clone() for k, v in model.state_dict().items()
              if k.split(".", 1)[0] in FROZEN_KEYS}
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    batches = mt.combined_batches(TRAIN_STEPS + 1, SEED + 13)
    generator = torch.Generator("cuda").manual_seed(SEED + 7)
    state, losses, seconds, peak_gib, counts = _train_steps(
        task, state, batches, generator)
    rgb, talknet = MT_STEMS["Unified3TaskTranslation"]
    expect = _expected(TRAIN_STEPS + 1, stem_pool_2d=rgb,
                       stem_pool_3d=talknet)
    moved, dead, changed = _check_trained("egot2g_train", model, before,
                                          frozen, losses, counts, expect)
    phase("egot2g_train", card=card, task="Unified3TaskTranslation",
          model="TaskTranslationPromptTransformer", dtype="float32",
          hidden=task.cfg.hidden_dim, layers=task.cfg.num_layers,
          heads=task.cfg.num_heads, **_mt_shapes(mt), steps=TRAIN_STEPS,
          batches_per_s=TRAIN_STEPS / seconds,
          ms_per_step=seconds / TRAIN_STEPS * 1e3, peak_mem_gib=peak_gib,
          losses=losses, leaves_moved=f"{moved} of {len(before)}",
          leaves_with_zero_gradient=dead, frozen_entries=len(frozen),
          frozen_entries_changed=changed, launches=counts,
          expected_launches=expect)
    loss_err, cosine, leaf, card_loss, cpu_loss = _train_check(
        task, state, batches[0])
    phase("egot2g_train_check", vs="cpu", clips=TRAIN_CHECK_CLIPS,
          dropout=0.0, loss_card=card_loss, loss_cpu=cpu_loss,
          loss_rel_err=loss_err, loss_rtol=TRAIN_LOSS_RTOL[False],
          min_grad_cosine=cosine, min_grad_cosine_leaf=leaf,
          cosine_bar=TRAIN_GRAD_COSINE[False])
    if not loss_err <= TRAIN_LOSS_RTOL[False]:
        fail(f"egot2g_train: card loss {card_loss} vs CPU {cpu_loss}")
    if not cosine >= TRAIN_GRAD_COSINE[False]:
        fail(f"egot2g_train: gradient of {leaf} at cosine {cosine} with "
             "the CPU's")
    return counts


def egot2g_fit_phase(card, task, state, batch):
    """``Trainer.fit`` of the task with ``fast_dev_run`` on a
    ``CombinedLoader`` of ``batch`` from ``state``: one train step and one
    validation batch, with every launch count set to 0 just before and
    read just after (each an encoding of every task's batch); finite
    metrics in range. Returns the launch counts."""
    import tempfile

    from egot2x_torch.data.combined import CombinedLoader
    from egot2x_torch.train.trainer import Trainer

    loader = CombinedLoader({t: [b] for t, b in batch.items()})
    for fn in _counters().values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as root:
        trainer = Trainer(task, fast_dev_run=True, default_root_dir=root)
        state = trainer.fit(loader, loader, state=state)
    counts = {k: fn.launches for k, fn in _counters().items()}
    rgb, talknet = MT_STEMS[type(task).__name__]
    expect = _expected(2, stem_pool_2d=rgb, stem_pool_3d=talknet)
    (metrics,) = trainer.metrics_history
    phase("egot2g_fit", card=card, task=type(task).__name__,
          trainer="fast_dev_run", loader="CombinedLoader", metrics=metrics,
          launches=counts, expected_launches=expect)
    if counts != expect:
        fail(f"egot2g_fit: launches {counts}, expected {expect}")
    if not (math.isfinite(metrics["val_loss"])
            and all(0.0 <= v <= 1.0 for k, v in metrics.items()
                    if k.startswith("val_") and k != "val_loss")):
        fail(f"egot2g_fit: metrics {metrics}")
    return counts


def egot2g_phase(card):
    """EgoT2-g HHI at run_multitask's widths: both tasks' eval on one
    combined batch, the long ASD track, frozen training, the Trainer.
    Returns the launch counts of each path."""
    from egot2x_torch.tools import profile_egot2g as mt

    batch = mt.combined_batches(1, SEED + 10)[0]
    counts = {}
    for name in MT_TASKS:
        task, state, counts[f"eval_{name}"] = egot2g_eval_phase(card, name,
                                                                batch)
        if name == "Unified3TaskTranslation":
            counts["long_track"] = egot2g_long_phase(card, state.model)
            counts["train"] = egot2g_train_phase(card, task, state)
            counts["fit"] = egot2g_fit_phase(card, task, state, batch)
        del task, state
    return counts


def nvjpeg_phase():
    """nvJPEG's version through the data plane's library (``jpeg.cu``,
    built with the kernels): the card's JPEG decoder and encoder."""
    from egot2x_torch.data import image

    version = image.nvjpeg_version()
    phase("device", nvjpeg=version)
    return version


def _noise_frames(n, seed):
    """(n, 512, 512, 3) uint8 frames drawn as the TTM fixture draws its
    (``make_ttm_fixture`` at img_size 256: uniform noise)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (n, 2 * FACE, 2 * FACE, 3), dtype=np.uint8)


def _chroma_blocks(rgb):
    """(h/2, w/2, 2) Cb and Cr (JFIF's BT.601) of uint8 RGB, averaged over
    each 2x2 block: one 4:2:0 chroma sample's footprint, where decoders
    that upsample the chroma differently agree but for colour edges."""
    import numpy as np

    h, w = rgb.shape[0] // 2 * 2, rgb.shape[1] // 2 * 2
    r, g, b = (rgb[:h, :w, k].astype(np.float64) for k in range(3))
    c = np.stack([128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
                  128 + 0.5 * r - 0.418688 * g - 0.081312 * b], -1)
    return c.reshape(h // 2, 2, w // 2, 2, 2).mean((1, 3))


def _crop_bound(frames, boxes, out):
    """Least time of a crop_resize: the bytes of each crop that lie in its
    frame read once (every source pixel of a down-scaled crop is a tap;
    taps past the frame take the fill value and read nothing) and the
    output written once, at HBM bandwidth (the integer arithmetic, ~12
    operations an output byte, is far below the card's rate)."""
    read = 0
    for img, (x1, y1, x2, y2) in zip(frames, boxes):
        h, w = img.shape[:2]
        c = img.shape[2] if img.dim() == 3 else 1
        cw = min(int(x2), w) - max(int(x1), 0)
        ch = min(int(y2), h) - max(int(y1), 0)
        read += max(cw, 0) * max(ch, 0) * c
    nbytes = read + out.numel()
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes


def data_phase():
    """The card's data plane: nvJPEG's decode of cv2-written reference
    JPEGs against cv2's decode; an encode-decode round trip; the
    crop_resize kernel against its plain version at the main path's
    shapes, bit for bit, with its time, bound and F.interpolate's; the
    decode and loader rates on 512^2 frames. Returns the kernel's row."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    import torch.nn.functional as F

    from egot2x_torch.data import image
    from egot2x_torch.data.asd import square_window

    dev = torch.device("cuda")
    refs = ROOT / "egot2x_torch" / "tools" / "jpeg_refs"
    decoded = np.load(refs / "decoded.npz")
    luma = lambda x: (x.astype(np.int64) @ np.int64(image.GREY)
                      + (1 << 13)) >> 14
    for name in sorted(decoded.files):
        want = decoded[name]
        got = image.decode_jpeg((refs / f"{name}.jpg").read_bytes(), dev)
        got = got.cpu().numpy()
        if got.shape != want.shape:
            fail(f"nvJPEG decoded {name} as {got.shape}, not {want.shape}")
        diff = np.abs(got.astype(np.int16) - want)
        dluma = np.abs(luma(got) - luma(want))
        dchroma = np.abs(_chroma_blocks(got) - _chroma_blocks(want))
        swapped = float(np.abs(_chroma_blocks(got)[..., ::-1]
                               - _chroma_blocks(want)).mean())
        full = name == FULL_CHROMA
        phase("data", check="nvjpeg_vs_libjpeg", ref=name,
              chroma="4:4:4" if full else "4:2:0", shape=list(want.shape),
              max_abs_diff=int(diff.max()), mean_abs_diff=float(diff.mean()),
              share_differ=float((diff > 0).mean()),
              luma_max_abs_diff=int(dluma.max()),
              luma_mean_abs_diff=float(dluma.mean()),
              chroma_2x2_mean_abs_diff=float(dchroma.mean()),
              chroma_2x2_max_abs_diff=float(dchroma.max()),
              chroma_swapped_2x2_mean_abs_diff=swapped,
              bar=(f"max <= {JPEG_444_MAX}" if full
                   else f"luma mean <= {JPEG_LUMA_MEAN}")
              + f", chroma 2x2 mean <= {JPEG_CHROMA_MEAN}")
        if (diff.max() > JPEG_444_MAX) if full else (
                dluma.mean() > JPEG_LUMA_MEAN):
            fail(f"nvJPEG's decode of {name} is not libjpeg's image")
        if dchroma.mean() > JPEG_CHROMA_MEAN:
            fail(f"nvJPEG's chroma of {name} is not libjpeg's")
        if swapped <= JPEG_CHROMA_MEAN:
            fail(f"the chroma check cannot tell {name}'s Cb from its Cr")
        again = image.decode_jpeg(image.encode_jpeg(
            torch.from_numpy(want).to(dev)), dev).cpu().numpy()
        gap = float(np.abs(luma(again) - luma(want)).mean())
        chroma_gap = float(np.abs(_chroma_blocks(again)
                                  - _chroma_blocks(want)).mean())
        phase("data", check="nvjpeg_encode_decode", ref=name,
              luma_mean_abs_diff=gap, chroma_2x2_mean_abs_diff=chroma_gap,
              bar=f"luma mean <= {JPEG_ROUND_TRIP_LUMA}, chroma 2x2 mean "
                  f"<= {JPEG_CHROMA_MEAN}")
        if gap > JPEG_ROUND_TRIP_LUMA or chroma_gap > JPEG_CHROMA_MEAN:
            fail(f"nvJPEG's encode-decode of {name} is {gap} (luma), "
                 f"{chroma_gap} (chroma) off")

    # crop_resize at one TTM 2-loader item of the 150-frame bucket: 512^2
    # frames, 256^2 face boxes -> 224^2 RGB, and the grey squares (fill
    # 110, taps outside the frame) -> 224^2, flipped as ASD's augmentation
    frames = [torch.from_numpy(f).to(dev) for f in _noise_frames(CROP_N,
                                                                 SEED + 20)]
    faces = np.tile(np.float32([4, 4, 4 + FACE, 4 + FACE]), (CROP_N, 1))
    squares = np.float32([square_window(2 * FACE, 2 * FACE, 4 + FACE / 2,
                                        4 + FACE / 2, FACE / 2)] * CROP_N)
    cases = {"rgb": (faces, dict()),
             "grey_square": (squares, dict(grey=True, flip=True, fill=110))}
    row = None
    for name, (boxes, kw) in cases.items():
        out = image.crop_resize(frames, boxes, IMG, **kw)
        torch.cuda.synchronize()
        ref = image.crop_resize_plain(frames, boxes, IMG, **kw)
        err = int((out.short() - ref.short()).abs().max())
        # the kernel alone (a CUDA graph of launches on prepared words:
        # the wrapper's host work, ~0.1 ms for 150 frames, would otherwise
        # gap the card's timeline), and the wrapper as the loader calls it
        flips = [kw.get("flip", False)] * CROP_N
        words = torch.from_numpy(image._items(
            frames, boxes, kw.get("grey", False), flips,
            kw.get("fill", image.FILL_CLAMP))).to(dev)
        r = dict(kernel="crop_resize", case=name, frames=CROP_N,
                 frame=[2 * FACE, 2 * FACE, 3], box=boxes[0].tolist(),
                 out_shape=list(out.shape), max_abs_err=err, tol=0,
                 ok=err == 0, ms=graph_ms(lambda: image.launch(words, out),
                                          FLASH_ITERS),
                 wrapper_ms=time_ms(lambda: image.crop_resize(
                     frames, boxes, IMG, **kw)),
                 plain_ms=time_ms(lambda: image.crop_resize_plain(
                     frames, boxes, IMG, **kw), iters=2))
        r["bound_ms"], r["bound_by"], r["bytes"] = _crop_bound(frames, boxes,
                                                               out)
        if name == "rgb":   # one call: the crops stacked, in float32
            crops = torch.stack([f[4:4 + FACE, 4:4 + FACE] for f in frames]
                                ).permute(0, 3, 1, 2).float()
            r["library_ms"] = time_ms(lambda: F.interpolate(
                crops, size=(IMG, IMG), mode="bilinear", align_corners=False))
            r["library"] = (f"F.interpolate bilinear, f32 ({CROP_N}, 3, "
                            f"{FACE}, {FACE})")
            row = r
        phase("data", **r)
        if err:
            fail(f"crop_resize {name} differs from its plain version by "
                 f"{err}")
    del frames

    # decode and loader rates on the fixture's 512^2 frames, warm reads
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for k, f in enumerate(_noise_frames(RATE_FRAMES, SEED + 21)):
            paths.append(f"{d}/img_{k:05d}.jpg")
            image.write_jpeg(paths[-1], f, dev)
        mean_kb = sum(Path(p).stat().st_size for p in paths) / len(paths)
        box = np.float32([[4, 4, 4 + FACE, 4 + FACE]] * RATE_ITEM)

        def item(chunk):
            imgs = [image.read_jpeg(p, dev) for p in chunk]
            return image.crop_resize(imgs, box[:len(imgs)], IMG)

        chunks = [paths[i:i + RATE_ITEM]
                  for i in range(0, len(paths), RATE_ITEM)]
        item(chunks[0])
        torch.cuda.synchronize()
        rates = {}
        for name, run in (
                ("decode_1_thread", lambda: [image.read_jpeg(p, dev)
                                             for p in paths]),
                ("decode_crop_1_thread", lambda: [item(c) for c in chunks]),
                ("decode_crop_8_threads", lambda: list(ThreadPoolExecutor(
                    8).map(item, chunks)))):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            rates[name] = len(paths) / (time.perf_counter() - t0)
        phase("data", check="loader_rate", frames=len(paths),
              frame=[2 * FACE, 2 * FACE, 3], mean_jpeg_kb=mean_kb / 1024,
              out=IMG, frames_per_s=rates)
    row.update(name="crop_resize", route="cuda",
               source="egot2x_torch/csrc/jpeg.cu",
               replaces=("none: no TPU kernel (the JAX package's host data "
                         "plane, egot2x/native/dataplane.cpp:73)"),
               dtype="uint8", design="one thread an output pixel, 4 taps "
                                     "through L1, dataplane.cpp's integers",
               shapes=(f"{CROP_N} frames of {2 * FACE}^2, {FACE}^2 boxes -> "
                       f"{IMG}^2 RGB"))
    return row


def _cli_argv(*args):
    return [*args, "--device", "cuda"]


def cli_phase(card):
    """``run_ttm --two_loader --model TaskFusionMFTransformer3Task`` at the
    CLI's widths (hidden 256, 4 heads, 3 layers, dropout 0.1, lr 5e-4,
    400-frame batches, 10 loader threads) for one epoch on a TTM fixture
    of 512^2 frames written on the card by nvJPEG (face boxes 256^2,
    resized to 224), every count set to 0 just before and read just
    after: each train step's batch must come from the card loader (CUDA
    tensors before the Trainer moves anything) and launch exactly 2 + 1
    stems; then ``run_lam``, ``run_asd`` and ``run_multitask`` with
    ``--synthetic --fast_dev_run`` on the card. Returns the main path's
    launch counts."""
    import shutil
    import tempfile

    import torch

    from egot2x_torch.cli import run_asd, run_lam, run_multitask, run_ttm
    from egot2x_torch.data import image, synthetic
    from egot2x_torch.data.ttm_2task import TtmTwoTaskDataset
    from egot2x_torch.tasks.ttm_2loader import TalkingToMe2Loader
    from egot2x_torch.train.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    saved_tmp, cwd = tempfile.tempdir, os.getcwd()
    step_fn, put_fn = TalkingToMe2Loader.train_step, Trainer._device_batch
    item_fn = TtmTwoTaskDataset.get_item
    steps, from_card, marks, items = [], [], [], []
    try:
        os.chdir(tmp)
        tempfile.tempdir = tmp   # the --synthetic trees, the logs
        t0 = time.perf_counter()
        root = synthetic.make_ttm_fixture(os.path.join(tmp, "ttm"),
                                          img_size=FACE, device="cuda")
        fixture_s = time.perf_counter() - t0

        def device_batch(self, batch):
            frames = batch.get("frames")
            from_card.append(isinstance(frames, torch.Tensor)
                             and frames.is_cuda)
            return put_fn(self, batch)

        def train_step(self, state, batch, generator):
            before = {k: fn.launches for k, fn in _counters().items()}
            marks.append(time.perf_counter())
            out = step_fn(self, state, batch, generator)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            steps.append(dict(
                frames=list(batch["frames"].shape[:2]),
                launches={k: fn.launches - before[k]
                          for k, fn in _counters().items()}))
            return out

        def get_item(self, idx, n_frames):
            items.append(n_frames)
            return item_fn(self, idx, n_frames)

        TalkingToMe2Loader.train_step = train_step
        Trainer._device_batch = device_batch
        TtmTwoTaskDataset.get_item = get_item
        for fn in _counters().values():
            fn.launches = 0
        image.decode_jpeg.decodes = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = run_ttm.main(_cli_argv(
            "--two_loader", "--model", "TaskFusionMFTransformer3Task",
            "--data_root", root, "--img_size", str(IMG), "--epochs", "1",
            "--output_dir", "chip_smoke"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in _counters().items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        TalkingToMe2Loader.train_step = step_fn
        Trainer._device_batch = put_fn
        TtmTwoTaskDataset.get_item = item_fn
    step_ms = [(b - a) * 1e3 for a, b in zip(marks[::2], marks[1::2])]
    # from one step's end to the next one's start: the Trainer waits for
    # the loader's next batch (and moves it)
    wait_ms = [(a - b) * 1e3 for a, b in zip(marks[2::2], marks[1::2])]
    timed = step_ms[1:]   # the first step builds cuDNN's plans
    host = sum(wait_ms) / (sum(wait_ms) + sum(timed)) if timed else None
    phase("cli", card=card, cli="run_ttm --two_loader", model=(
        "TaskFusionMFTransformer3Task"), hidden=256, heads=4, layers=3,
          img_size=IMG, frames_budget=400,
          fixture=f"{2 * FACE}^2 noise frames, {FACE}^2 faces, nvJPEG q95 4:2:0",
          fixture_seconds=fixture_s, wall_seconds=wall, train_steps=len(steps),
          batches=[s["frames"] for s in steps], ms_per_step=step_ms,
          mean_ms_per_step=sum(timed) / max(len(timed), 1),
          loader_wait_ms=wait_ms, host_share_of_step=host,
          peak_mem_gib=peak, decodes=image.decode_jpeg.decodes,
          items=len(items), device_batches=len(from_card),
          launches=counts, metrics=metrics,
          step_launches=[s["launches"] for s in steps])
    if not steps or not all(from_card):
        fail(f"cli: batches not from the card loader ({from_card})")
    # a step: 2 RGB stems and a TalkNet stem (the loader's crop launches
    # for the batches it builds meanwhile are counted over the run)
    for s in steps:
        got = {k: v for k, v in s["launches"].items() if k != "crop_resize"}
        expect = dict({k: 0 for k in got}, stem_pool_2d=2, stem_pool_3d=1)
        if got != expect:
            fail(f"cli: a step launched {got}, expected {expect}")
    # every batch (train, and validation after fit and again after it)
    # a forward of 2 + 1 stems; every item 2 crop_resize launches (RGB
    # faces, grey squares) and a decode a frame
    forwards = len(from_card)
    expect = dict({k: 0 for k in counts}, stem_pool_2d=2 * forwards,
                  stem_pool_3d=forwards, crop_resize=2 * len(items))
    if counts != expect or image.decode_jpeg.decodes != sum(items):
        fail(f"cli: launches {counts}, expected {expect}; decodes "
             f"{image.decode_jpeg.decodes} for {sum(items)} frames")
    if not all(math.isfinite(v) for v in metrics.values()):
        fail(f"cli: metrics {metrics}")
    try:
        tempfile.tempdir = tmp
        for module, args in ((run_lam, ()), (run_asd, ()),
                             (run_asd, ("--two_loader",)),
                             (run_multitask, ()),
                             (run_multitask, ("--task", "unified"))):
            before = image.crop_resize.launches
            t0 = time.perf_counter()
            m = module.main(_cli_argv("--synthetic", "--fast_dev_run", *args))
            launched = image.crop_resize.launches - before
            phase("cli", cli=f"{module.__name__.rsplit('.', 1)[1]} "
                             f"{' '.join(args)}".strip(),
                  seconds=time.perf_counter() - t0, metrics=m,
                  crop_resize_launches=launched)
            if not all(math.isfinite(v) for v in m.values()) or not launched:
                fail(f"cli: {module.__name__} {args}: {m}")
    finally:
        tempfile.tempdir = saved_tmp
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def _seeded(name, device=None, seed=SEED, **kw):
    """``name`` built by ``build_model`` with the bridge's weights drawn
    from ``seed``."""
    from egot2x_torch.core import bridge
    from egot2x_torch.core.registry import build_model

    model = build_model(name, device=device, **kw)
    bridge.load_jax_variables(model, bridge.random_jax_variables(model, seed))
    return model


def _cpu_twin(name, model, **kw):
    """``name`` on the CPU (plain versions) with ``model``'s state."""
    from egot2x_torch.core.registry import build_model

    cpu = build_model(name, device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return cpu


def ttm_baselines_phase(card, request):
    """The TTM baselines at run_ttm --two_loader's widths on one request
    (16 clips x 30 frames, RGB 224^2, faces 112^2, MFCC), every launch
    count set to 0 just before and read just after: per model a warm-up,
    one timed forward (f32 feed) and the uint8 feed, exact stem launches,
    finite logits, the feeds agreeing, clip 0 against the port's CPU
    forward; then one frozen train step of ``FinetuneTTM`` through
    ``TalkingToMe2Loader`` after a warm-up one: the head moves, the trunk's
    weights and BN statistics stay bit for bit. Returns the launch
    counts."""
    import torch

    from egot2x_torch.core.config import Config
    from egot2x_torch.tasks.ttm_2loader import TalkingToMe2Loader

    feeds = {f: [torch.from_numpy(a).cuda() for a in request[f]]
             for f in ("f32", "u8")}
    mfcc = torch.from_numpy(request["mfcc"]).cuda()
    audio = torch.zeros(B, T * 16000 // 30, device="cuda")
    widths = dict(hidden_dim=TTM_HIDDEN, hidden_dim2=TTM_HIDDEN2)
    models = {name: _seeded(name, seed=SEED + i, **widths)
              for i, name in enumerate(TTM_BASELINES)}
    for fn in _counters().values():
        fn.launches = 0
    forwards, outs = {}, {}
    with torch.no_grad():
        for name, model in models.items():
            model(*feeds["f32"], audio, mfcc)                # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            logits = model(*feeds["f32"], audio, mfcc)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            u8 = model(*feeds["u8"], audio, mfcc)
            outs[name] = logits
            forwards[name] = 3
            _check_finite(f"ttm_baselines {name}", {"f32": logits, "u8": u8},
                          (B, 2))
            scale = 1.0 + float(logits.abs().max())
            feed_err = float((u8 - logits).abs().max())
            want = _cpu_twin(name, model, **widths)(
                *(torch.from_numpy(a[:1]) for a in request["f32"]),
                audio[:1].cpu(), torch.from_numpy(request["mfcc"][:1]))
            errs = _check_close(f"ttm_baselines {name}, clip 0 card vs CPU",
                                {"logits": logits[:1]}, {"logits": want})
            phase("ttm_baselines", card=card, model=name, **widths,
                  clips=B, frames=T, rgb=IMG, faces=ASD_IMG, ms=ms,
                  clips_per_s=B * 1e3 / ms,
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                  max_abs_err_cpu_clip0=errs["logits"],
                  max_abs_err_u8_vs_f32_feed=feed_err, tol=LOGIT_TOL,
                  logits_clip0_card=logits[0].tolist(),
                  logits_clip0_cpu=want[0].tolist())
            if feed_err > LOGIT_TOL * scale:
                fail(f"ttm_baselines {name}: uint8 feed differs from the "
                     f"f32 feed by {feed_err}")
    counts = {k: fn.launches for k, fn in _counters().items()}
    expect = _expected(1, stem_pool_2d=sum(
        forwards[n] * TTM_BASELINES[n][0] for n in models), stem_pool_3d=sum(
        forwards[n] * TTM_BASELINES[n][1] for n in models))
    phase("ttm_baselines", launches=counts, expected_launches=expect,
          per_forward={n: dict(zip(("stem_pool_2d", "stem_pool_3d"), v))
                       for n, v in TTM_BASELINES.items()})
    if counts != expect:
        fail(f"ttm_baselines: launches {counts}, expected {expect}")
    del models, outs
    torch.cuda.empty_cache()

    # one frozen train step through the task, after a warm-up step
    task = TalkingToMe2Loader(Config(
        model="FinetuneTTM", weights=TTM_CLASS_WEIGHTS, lr=5e-4, wd=0.0,
        hidden_dim=TTM_HIDDEN))
    state = task.build_state(SEED)
    model = state.model
    head = {n: p.detach().clone() for n, p in model.named_parameters()
            if p.requires_grad}
    trunk = {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith("ttm_model.")}
    generator = torch.Generator("cuda").manual_seed(SEED + 7)
    state, losses, seconds, peak_gib, step_counts = _train_steps(
        task, state, _train_batches(2, SEED + 30), generator)
    expect = _expected(2, stem_pool_2d=1)
    moved, dead, changed = _check_trained(
        "ttm_baselines train", model, head, trunk, losses, step_counts,
        expect)
    phase("ttm_baselines_train", card=card, model="FinetuneTTM",
          task="TalkingToMe2Loader", hidden=TTM_HIDDEN,
          hidden2=TTM_HIDDEN2, clips=B, frames=T, ms_per_step=seconds * 1e3,
          peak_mem_gib=peak_gib, losses=losses,
          head_leaves_moved=f"{moved} of {len(head)}",
          leaves_with_zero_gradient=dead, trunk_entries=len(trunk),
          trunk_entries_changed=changed, launches=step_counts,
          expected_launches=expect)
    if not all(k.startswith("head.") for k in head):
        fail(f"ttm_baselines train: trainable outside the head: "
             f"{sorted(k for k in head if not k.startswith('head.'))[:3]}")
    return {k: counts[k] + step_counts[k] for k in counts}


def _pnr_labels(n, seed):
    """Seeded PNR labels of ``n`` clips: state change, one-hot keyframes,
    fps and the clip's frame span and PNR frame."""
    import numpy as np

    rng = np.random.default_rng(seed)
    start = rng.integers(0, 300, n)
    return dict(state=rng.integers(0, 2, n),
                keyframes=np.eye(PNR_FRAMES)[rng.integers(0, PNR_FRAMES, n)],
                fps=np.full(n, 30.0), start=start, end=start + 240,
                pnr=start + rng.integers(0, 240, n))


def _pnr_metrics(kind, out, labels):
    """The PNR metrics of the CPU clips' outputs: keyframe distance and
    accuracy of keyframe logits or scores, state-change accuracy of
    state logits."""
    import numpy as np

    from egot2x_torch.metrics import pnr

    out = {k: np.asarray(v.float().cpu())[:PNR_CPU_CLIPS]
           for k, v in out.items()}
    lab = {k: v[:PNR_CPU_CLIPS] for k, v in labels.items()}
    got = {}
    if "keyframe" in out:
        got["keyframe_distance"] = pnr.keyframe_distance(
            out["keyframe"], lab["state"], lab["fps"], lab["start"],
            lab["end"], lab["pnr"], num_frames=PNR_FRAMES)
        got["keyframe_accuracy"] = pnr.keyframe_accuracy(
            out["keyframe"], lab["keyframes"], lab["state"])
    if "state" in out:
        got["state_change_accuracy"] = pnr.state_change_accuracy(
            out["state"], lab["state"])
    return got


# (model, kwargs, what it answers): a keyframe model's "keyframe" are its
# (B, T) logits or scores, a state model's "state" its (B, 2) logits
PNR_MODELS = (
    ("KeyframeLocalizationResNet", dict(nonlocal_cfg=PNR_NONLOCAL),
     ("keyframe",)),
    ("StateChangeClsResNet", dict(), ("state",)),
    ("StateChangeClsResNet", dict(no_temp_pool=True), ("state",)),
    ("DualHeadResNet", dict(), ("keyframe", "state")),
    ("KeyframeCnnLSTM", dict(), ("keyframe",)),
)


def _pnr_outputs(name, out):
    """{"keyframe": (B, T), "state": (B, 2)} of a PNR model's output."""
    if name == "DualHeadResNet":
        return {"keyframe": out[0], "state": out[1]}
    if name == "KeyframeLocalizationResNet":
        return {"keyframe": out[..., 0]}   # as the PNR task squeezes it
    if name == "KeyframeCnnLSTM":
        return {"keyframe": out}
    return {"state": out}


def _pnr_build(name, kw, calibration):
    """A PNR model on the card with the seeded weights, the statistics of
    its stem's BN and of its dot_product Nonlocals' BNs fitted to
    ``calibration`` by precise BN."""
    from egot2x_torch.nn.resnet3d import Nonlocal, resolve_nonlocal
    from egot2x_torch.train.precise_bn import compute_precise_bn_stats

    kw = dict(kw)
    if "nonlocal_cfg" in kw:
        kw["nonlocal_cfg"] = resolve_nonlocal(kw["nonlocal_cfg"])
    if name != "KeyframeCnnLSTM":
        kw["crop_size"] = PNR_CROP
    model = _seeded(name, **kw)
    stem_bn = (model.backbone.bn1 if name == "KeyframeCnnLSTM"
               else model.trunk.s1.bn)
    bns = [stem_bn] + [m.bn for m in model.modules()
                       if isinstance(m, Nonlocal)
                       and m.instantiation == "dot_product"]
    compute_precise_bn_stats(model, [(calibration,)], 1, bns=bns)
    return model, kw


def _busy_share(forward):
    """One forward traced by ``torch.profiler``: (device busy share of its
    wall time, device ms by kernel class)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from egot2x_torch.tools.profile_flagship import device_breakdown

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    row = device_breakdown(prof, 1, traced_ms)
    return row["device_busy_share"], row["by_category"]


def hoi_phase(card):
    """HOI Stage-I inference at pnr_train's defaults: kernel 1 at the PNR
    crop (256 frames of 225^2) against its plain version first; then each
    PNR model (``PNR_MODELS``) with every launch count set to 0 just before
    and read just after: a warm-up, ``PNR_REPEATS`` timed forwards of the
    f32 [0, 255] feed, the uint8 feed (``KeyframeCnnLSTM`` also the
    ImageNet-normalised f32 feed its uint8 feed equals) and the keyframe
    model's tokens; exact stem launches (one a ``KeyframeCnnLSTM`` forward,
    none on the ResNet3D models, whose video stem is the library's);
    finite outputs of the expected shapes; the feeds agreeing; the first
    ``PNR_CPU_CLIPS`` clips against the port's CPU forward (LOGIT_TOL,
    tokens TOKEN_TOL of their norm) and the PNR metrics of those clips
    equal; ms a batch, clips/s, peak memory and the device's busy share
    (one traced forward). Returns (launch counts, the 225^2 kernel rows)."""
    import numpy as np
    import torch

    from egot2x_torch.data.lam import normalize_frames

    rng = np.random.default_rng(SEED + 40)
    frames_u8 = rng.integers(0, 256, (PNR_CLIPS, PNR_FRAMES, PNR_CROP,
                                      PNR_CROP, 3), dtype=np.uint8)
    calibration = torch.from_numpy(rng.integers(
        0, 256, frames_u8.shape, dtype=np.uint8)).cuda()
    u8 = torch.from_numpy(frames_u8).cuda()
    f32 = u8.float()
    labels = _pnr_labels(PNR_CLIPS, SEED + 41)

    w, scale, bias = _stem_params("2d")
    flat = f32.reshape(-1, PNR_CROP, PNR_CROP, 3)
    rows = {dtype: _float_stem_row("2d", flat.to(getattr(torch, dtype)), w,
                                   scale, bias, name="hoi_kernel", f64=True,
                                   path="KeyframeCnnLSTM at the PNR crop, "
                                        "raw 0-255 frames")
            for dtype in ("float32", "bfloat16")}
    del flat

    total = {k: 0 for k in _counters()}
    for name, kw, answers in PNR_MODELS:
        cnn = name == "KeyframeCnnLSTM"
        model, kw = _pnr_build(name, kw, calibration.float() if cnn
                               else calibration)
        feeds = {"f32": f32, "u8": u8}
        if cnn:   # its uint8 feed is ImageNet-normalised, as in egot2x
            feeds["f32_normalised"] = torch.from_numpy(
                normalize_frames(frames_u8)).cuda()
        for fn in _counters().values():
            fn.launches = 0
        with torch.no_grad():
            model(f32)                                       # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(PNR_REPEATS):
                out = model(f32)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / PNR_REPEATS * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30
            other = {f: model(x) for f, x in feeds.items() if f != "f32"}
            tokens = (model(f32, middle=True)
                      if name == "KeyframeLocalizationResNet" else None)
            torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in _counters().items()}
        forwards = PNR_REPEATS + 1 + len(other) + (tokens is not None)
        expect = _expected(forwards, stem_pool_2d=1 if cnn else 0)
        for k in total:
            total[k] += counts[k]
        label = name + (" no_temp_pool" if kw.get("no_temp_pool") else "")
        if counts != expect:
            fail(f"hoi {label}: launches {counts}, expected {expect}")
        busy, by_category = _busy_share(lambda: model(f32))

        outs = _pnr_outputs(name, out)
        shapes = {"keyframe": (PNR_CLIPS, PNR_FRAMES),
                  "state": (PNR_CLIPS, 2)}
        for key, v in outs.items():
            _check_finite(f"hoi {label}", {key: v}, shapes[key])
        if sorted(outs) != sorted(answers):
            fail(f"hoi {label}: answers {sorted(outs)}")
        if tokens is not None:
            _check_finite(f"hoi {label}", {"tokens": tokens},
                          (PNR_CLIPS, PNR_FRAMES, 8192))
        # the feeds: uint8 = f32 [0, 255] (cast only), KeyframeCnnLSTM's
        # uint8 = the ImageNet-normalised f32 feed
        ref_feed = "f32_normalised" if cnn else "f32"
        ref = outs if ref_feed == "f32" else _pnr_outputs(name,
                                                          other[ref_feed])
        feed_errs = _check_close(f"hoi {label}: uint8 vs {ref_feed} feed",
                                 _pnr_outputs(name, other["u8"]), ref)

        cpu = _cpu_twin(name, model, **kw)
        t0 = time.perf_counter()
        with torch.no_grad():
            x = f32[:PNR_CPU_CLIPS].cpu()
            want = _pnr_outputs(name, cpu(x))
            want_tokens = (cpu(x, middle=True) if tokens is not None
                           else None)
        cpu_s = time.perf_counter() - t0
        errs = _check_close(f"hoi {label}, clips 0-{PNR_CPU_CLIPS - 1} "
                            "card vs CPU",
                            {k: v[:PNR_CPU_CLIPS] for k, v in outs.items()},
                            want)
        token_err = None
        if tokens is not None:
            gap = (tokens[:PNR_CPU_CLIPS].cpu() - want_tokens).norm(dim=-1)
            token_err = float((gap / want_tokens.norm(dim=-1)).max())
            if not token_err <= TOKEN_TOL:
                fail(f"hoi {label}: tokens {token_err} of their norm off "
                     "the CPU's")
        got_m, want_m = (_pnr_metrics(name, outs, labels),
                         _pnr_metrics(name, want, labels))
        if got_m != want_m:
            fail(f"hoi {label}: metrics {got_m} vs the CPU's {want_m}")
        phase("hoi", card=card, model=name, **{
                  k: v for k, v in kw.items() if k != "nonlocal_cfg"},
              nonlocal_cfg=kw.get("nonlocal_cfg"), clips=PNR_CLIPS,
              frames=PNR_FRAMES, crop=PNR_CROP, feed="raw [0, 255] f32",
              ms_per_batch=ms, clips_per_s=PNR_CLIPS * 1e3 / ms,
              peak_mem_gib=peak, device_busy_share=busy,
              device_ms_by_category=by_category,
              out_shapes={k: list(v.shape) for k, v in outs.items()},
              token_shape=None if tokens is None else list(tokens.shape),
              max_abs_err_cpu=errs, token_err_of_norm=token_err,
              max_abs_err_feeds=feed_errs, tol=LOGIT_TOL,
              cpu_clips=PNR_CPU_CLIPS, cpu_seconds=cpu_s,
              metrics=got_m, metrics_cpu=want_m, launches=counts,
              expected_launches=expect,
              clip0_card={k: v[0].tolist() for k, v in outs.items()})
        del model, cpu, out, other, tokens
        torch.cuda.empty_cache()
    if total["stem_pool_2d"] == 0:
        fail("hoi: kernel 1 was never launched on the path")
    return total, rows


def _hoi_ts_inputs(slow_frames, seed):
    """uint8 frames (B, 16, 225, 225, 3) and pathways [slow (B, slow_frames,
    224, 224, 3), fast (B, 32, 224, 224, 3)] on the card, and the f32 feed
    (the frames cast, the pathways normalised as the stems normalise
    uint8 ones)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (HOI_TS_CLIPS, PNR_FRAMES, PNR_CROP,
                                   PNR_CROP, 3), dtype=np.uint8)
    paths = [rng.integers(0, 256, (HOI_TS_CLIPS, t, HOI_TS_IMG, HOI_TS_IMG,
                                   3), dtype=np.uint8)
             for t in (slow_frames, HOI_TS_FAST)]
    u8 = (torch.from_numpy(frames).cuda(),
          [torch.from_numpy(p).cuda() for p in paths])
    f32 = (u8[0].float(),
           [torch.from_numpy((p.astype(np.float32) / 255.0 - 0.45) / 0.225)
            .cuda() for p in paths])
    return u8, f32


def _first_clip(feed):
    """Clip 0 of a (frames, pathways) or (pathways,) feed, on the CPU."""
    cut = lambda x: ([t[:1].cpu() for t in x] if isinstance(x, list)
                     else x[:1].cpu())
    return tuple(cut(x) for x in feed)


def _serve_hoi(model, feeds, forward):
    """The served path of one HOI model: every launch count set to 0 just
    before, a warm-up, ``HOI_TS_REPEATS`` timed forwards of the f32 feed,
    one of the uint8 feed; the counts read just after. Returns (f32
    output, uint8 output, ms a batch, peak GiB, counts)."""
    import torch

    for fn in _counters().values():
        fn.launches = 0
    with torch.no_grad():
        forward(model, feeds["f32"])                         # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(HOI_TS_REPEATS):
            out = forward(model, feeds["f32"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / HOI_TS_REPEATS * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        u8 = forward(model, feeds["u8"])
        torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in _counters().items()}
    expect = _expected(HOI_TS_REPEATS + 2)
    if counts != expect:
        fail(f"hoi_ts {type(model).__name__}: launches {counts}, expected "
             f"{expect}")
    return out, u8, ms, peak, counts


def hoi_ts_phase(card):
    """HOI Stage-II inference: ts_pnr and ts_oscc
    (``TaskFusionMFTransformer3TaskDropout``) at their configs' widths,
    f32 (TF32 off) then bf16, and one ``MultiTaskSlowFast`` at the AR
    task's build, each through ``_serve_hoi`` (no kernel of the port on
    this path: the video stems are the library's, the encoders' 48 tokens
    never reach flash). Checks: finite outputs of the expected shapes; the
    uint8 feed equal to the f32 one and clip 0 equal to the port's CPU
    forward (f32, LOGIT_TOL); bf16 logits against f32 within
    HOI_TS_BF16_ONE_MINUS_COSINE and HOI_TS_BF16_MAX_ABS. Prints ms a
    batch, clips/s, peak memory and the busy share of one traced forward.
    Returns the launch counts."""
    import torch

    from egot2x_torch.train.precise_bn import compute_precise_bn_stats

    total = {k: 0 for k in _counters()}
    slow = HOI_TS_FAST // HOI_TS_ALPHA
    u8, f32 = _hoi_ts_inputs(slow, SEED + 50)
    calibration, _ = _hoi_ts_inputs(slow, SEED + 51)
    feeds = {"f32": f32, "u8": u8}
    translate = lambda model, feed: model(*feed)
    geometry = dict(crop_size=PNR_CROP, alpha=HOI_TS_ALPHA, beta_inv=8)
    name = "TaskFusionMFTransformer3TaskDropout"
    for i, (label, widths) in enumerate(HOI_TS_MODELS.items()):
        kw = dict(geometry, **widths)
        logits = {}
        for dtype in ("float32", "bfloat16"):
            if dtype == "float32":
                model = _seeded(name, seed=SEED + 52 + i, **kw)
                compute_precise_bn_stats(model, [calibration], 1, bns=[
                    model.pnr_model.trunk.s1.bn,
                    model.oscc_model.trunk.s1.bn])
                state = {k: v.cpu() for k, v in model.state_dict().items()}
            else:
                from egot2x_torch.core.registry import build_model

                model = build_model(name, dtype=torch.bfloat16, **kw)
                model.load_state_dict(state)
            out, out_u8, ms, peak, counts = _serve_hoi(model, feeds,
                                                       translate)
            for k in total:
                total[k] += counts[k]
            busy, by_category = _busy_share(lambda: model(*f32))
            n_out = 16 if widths["target"] == "keyframe" else 2
            _check_finite(f"hoi_ts {label} {dtype}",
                          {"logits": out, "logits_u8": out_u8},
                          (HOI_TS_CLIPS, n_out))
            feed_err = _check_close(f"hoi_ts {label} {dtype}: uint8 vs f32 "
                                    "feed", {"logits": out_u8},
                                    {"logits": out})
            logits[dtype] = out.float()
            check = dict(max_abs_err_feeds=feed_err)
            if dtype == "float32":
                cpu = _cpu_twin(name, model, **kw)
                t0 = time.perf_counter()
                with torch.no_grad():
                    want = cpu(*_first_clip(f32))
                check.update(cpu_seconds=time.perf_counter() - t0,
                             max_abs_err_cpu=_check_close(
                                 f"hoi_ts {label}: clip 0 card vs CPU",
                                 {"logits": out[:1]}, {"logits": want}))
                del cpu
            else:
                cosine = _cosine(logits["bfloat16"], logits["float32"])
                err = float((logits["bfloat16"] - logits["float32"]).abs()
                            .max())
                check.update(cosine_vs_f32=cosine, max_abs_err_vs_f32=err)
                if not (1 - cosine <= HOI_TS_BF16_ONE_MINUS_COSINE
                        and err <= HOI_TS_BF16_MAX_ABS):
                    fail(f"hoi_ts {label}: bf16 logits at cosine {cosine} "
                         f"and max |delta| {err} to f32's, past 1 - "
                         f"{HOI_TS_BF16_ONE_MINUS_COSINE} and "
                         f"{HOI_TS_BF16_MAX_ABS}")
            phase("hoi_ts", card=card, model=name, config=label,
                  dtype=dtype, **widths, tokens=2 * PNR_FRAMES + slow + 8,
                  clips=HOI_TS_CLIPS, frames=PNR_FRAMES, crop=PNR_CROP,
                  pathways=[slow, HOI_TS_FAST], pathway_img=HOI_TS_IMG,
                  alpha=HOI_TS_ALPHA, feed="f32: raw [0, 255] frames, "
                  "normalised pathways", ms_per_batch=ms,
                  clips_per_s=HOI_TS_CLIPS * 1e3 / ms, peak_mem_gib=peak,
                  device_busy_share=busy, device_ms_by_category=by_category,
                  launches=counts, tol=LOGIT_TOL,
                  bf16_bars=dict(
                      one_minus_cosine=HOI_TS_BF16_ONE_MINUS_COSINE,
                      max_abs=HOI_TS_BF16_MAX_ABS), **check,
                  clip0_card=out[0].float().tolist())
            del model, out, out_u8
            torch.cuda.empty_cache()

    u8, f32 = _hoi_ts_inputs(HOI_TS_FAST // AR_ALPHA, SEED + 53)
    u8, f32 = (u8[1],), (f32[1],)   # the pathways alone
    ar = dict(alpha=AR_ALPHA, num_classes=AR_CLASSES, depth=50)
    model = _seeded("MultiTaskSlowFast", seed=SEED + 54, **ar)
    out, out_u8, ms, peak, counts = _serve_hoi(
        model, {"f32": f32, "u8": u8}, lambda m, feed: m(*feed))
    for k in total:
        total[k] += counts[k]
    busy, by_category = _busy_share(lambda: model(*f32))
    outs = {"verbs": out[0], "nouns": out[1]}
    outs_u8 = {"verbs": out_u8[0], "nouns": out_u8[1]}
    for key, n in zip(("verbs", "nouns"), AR_CLASSES):
        _check_finite("hoi_ts MultiTaskSlowFast", {key: outs[key]},
                      (HOI_TS_CLIPS, n))
    feed_err = _check_close("hoi_ts MultiTaskSlowFast: uint8 vs f32 feed",
                            outs_u8, outs)
    cpu = _cpu_twin("MultiTaskSlowFast", model, **ar)
    with torch.no_grad():
        want = cpu(*_first_clip(f32))
    cpu_err = _check_close("hoi_ts MultiTaskSlowFast: clip 0 card vs CPU",
                           {k: v[:1] for k, v in outs.items()},
                           {"verbs": want[0], "nouns": want[1]})
    phase("hoi_ts", card=card, model="MultiTaskSlowFast", **ar,
          dtype="float32", clips=HOI_TS_CLIPS,
          pathways=[HOI_TS_FAST // AR_ALPHA, HOI_TS_FAST],
          pathway_img=HOI_TS_IMG, ms_per_batch=ms,
          clips_per_s=HOI_TS_CLIPS * 1e3 / ms, peak_mem_gib=peak,
          device_busy_share=busy, device_ms_by_category=by_category,
          launches=counts, tol=LOGIT_TOL, max_abs_err_feeds=feed_err,
          max_abs_err_cpu=cpu_err, out_shapes=[list(o.shape) for o in out])
    del model, cpu
    torch.cuda.empty_cache()
    return total


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
    nvjpeg_phase()
    kernels = {**kernel_phase(), **kernel_q_phase()}
    bwd_rows = stem_bwd_phase()
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
    (train_counts["train_full"], loss_full), (
        train_counts["train_full_remat"], loss_remat) = (
        train_full_phase(card, remat=False), train_full_phase(card, remat=True))
    phase("train_full_remat_check", first_loss=loss_full,
          first_loss_remat=loss_remat)
    if abs(loss_remat - loss_full) > 1e-6 * abs(loss_full):
        fail(f"remat's first loss {loss_remat} differs from {loss_full}")
    train_counts["asd2_train"] = asd2_train_phase(card, nofreeze=False)
    train_counts["asd2_train_nofreeze"] = asd2_train_phase(card,
                                                           nofreeze=True)
    val_counts = {}
    for name in ("stage1_lam", "stage1_ttm", "stage1_asd"):
        train_counts[name], val_counts[name] = stage1_phase(card, name)
    mt_counts = egot2g_phase(card)
    crop_row = data_phase()
    cli_counts = cli_phase(card)
    baseline_counts = ttm_baselines_phase(card, next(_requests()))
    hoi_counts, pnr_rows = hoi_phase(card)
    hoi_ts_counts = hoi_ts_phase(card)
    float_stem, int8_stem = ("egot2x/ops/pallas_stem.py:251",
                             "egot2x/ops/pallas_stem.py:373")
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
    # the stem's backward: its main path is nofreeze training (f32)
    bwd = _line_row("stem_pool_backward", bwd_rows["2d", "float32"],
                    train_counts["train_full"], float_stem + " (its "
                    "gradient: the JAX package differentiates its XLA "
                    "stems, egot2x/nn/resnet2d.py:165, egot2x/nn/"
                    "talknet.py:111; no Pallas backward)")
    bwd["design"] = ("gather of the <= 4 pooled outputs a pre-pool position "
                     "won + per-channel sums, then a pass over the blocks' "
                     "partials")
    bwd["shapes"] = ("2D at 480 frames of 224^2 (2 a step); the 3D row's "
                     "numbers in the stem_bwd phase")
    line.append(bwd)
    line.append(dict(
        {k: crop_row[k] for k in (
            "name", "route", "source", "replaces", "dtype", "design",
            "shapes", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        launches=cli_counts["crop_resize"]))
    # kernel 1 at the PNR crop (KeyframeCnnLSTM: 256 frames of 225^2)
    line[0]["pnr_225"] = {dtype: {k: r[k] for k in (
        "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")} for dtype, r in pnr_rows.items()}
    for row in line:   # the training paths' launches, beside the serving's
        row["train_launches"] = {path: counts[row["name"]]
                                 for path, counts in train_counts.items()}
        row["validation_launches"] = {path: counts[row["name"]]
                                      for path, counts in val_counts.items()}
        row["egot2g_launches"] = {path: counts[row["name"]]
                                  for path, counts in mt_counts.items()}
        row["cli_launches"] = cli_counts[row["name"]]
        row["ttm_baselines_launches"] = baseline_counts[row["name"]]
        row["hoi_launches"] = hoi_counts[row["name"]]
        row["hoi_ts_launches"] = hoi_ts_counts[row["name"]]
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""ASD (active speaker detection) data: TalkNet-style trials.

Counterpart of ``egot2x/data/asd.py``: CSV trial rows ``trackid \\t
numframes \\t fps \\t labels \\t ... \\t start`` (``trackid[:36]`` is the
video uid); audio is the wav slice [start / fps, (start + numframes) /
fps] over 32768, RMS-normalized to 0.1, as MFCC with the fps-scaled
window (4 rows a frame, ``audio/mfcc.py``); the faces are 112 x 112 grey
square crops around median-filtered sizes and smoothed centres. Training
augments, from a generator seeded by (seed, idx): the audio with another
trial's at an SNR of -5..5 dB, the faces by one of flip, crop-and-resize
and a +-15 degree rotation.

The faces are cut on the item's device by the data plane
(``data/image.py``): grey conversion, the square window (taps outside the
frame read 110, as the JAX package's ``np.pad`` does), the resize to 224,
and the flip, in one ``crop_resize`` launch for the whole track; the
crop augmentation is a second launch; the rotation is
:func:`warp_affine`, in torch on the same device (no kernel). Their
pixels are within 2 of the JAX package's ``cv2.resize`` and
``cv2.warpAffine``.

Layout: <root>/csv/active_speaker_{train,val}.csv, <root>/bbox/<trackid>.json,
<root>/wave/<uid>.wav, <root>/imgs/<uid>/img_%05d.jpg.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from egot2x_torch.audio.mfcc import mfcc_np
from egot2x_torch.core.registry import resolve_device
from egot2x_torch.data.bucketing import BucketedDataset
from egot2x_torch.data.image import crop_resize, normalize, read_jpeg

CROP_SIZE = 112
PAD_VALUE = 110   # np.pad's constant around a frame before the square crop
AUGMENTS = ("orig", "flip", "crop", "rotate")


def normalize_audio_int16(samples: np.ndarray, desired_rms: float = 0.1,
                          eps: float = 1e-4) -> np.ndarray:
    samples = samples / 32768.0
    rms = max(eps, float(np.sqrt(np.mean(samples ** 2))))
    return (samples * (desired_rms / rms)).astype(np.float32)


def overlap_noise(audio: np.ndarray, noise: np.ndarray,
                  snr_db: float) -> np.ndarray:
    """``noise`` (wrapped or cut to length) added to ``audio`` at
    ``snr_db`` (the reference's ``overlap``)."""
    if len(noise) < len(audio):
        noise = np.pad(noise, (0, len(audio) - len(noise)), mode="wrap")
    else:
        noise = noise[:len(audio)]
    noise_db = 10 * np.log10(np.mean(np.abs(noise ** 2)) + 1e-4)
    clean_db = 10 * np.log10(np.mean(np.abs(audio ** 2)) + 1e-4)
    noise = np.sqrt(10 ** ((clean_db - noise_db - snr_db) / 10)) * noise
    return (audio + noise).astype(np.float32)


def _medfilt(values, kernel: int) -> np.ndarray:
    """``scipy.signal.medfilt`` of a 1-D sequence: the median of each odd
    window of ``kernel``, zeros past the ends."""
    v = np.asarray(values, dtype=np.float64)
    if not v.size:
        return v
    v = np.pad(v, kernel // 2)
    return np.median(np.lib.stride_tricks.sliding_window_view(v, kernel),
                     axis=-1)


def smooth_dets(track: List[dict]) -> Dict[str, np.ndarray]:
    """Median-filtered half sizes and smoothed centres of a track's boxes
    (x, y, width, height)."""
    s, x, y = [], [], []
    for fr in track:
        x1, y1 = fr["x"], fr["y"]
        x2, y2 = fr["x"] + fr["width"], fr["y"] + fr["height"]
        s.append(max(y2 - y1, x2 - x1) / 2)
        y.append((y2 + y1) / 2)
        x.append((x2 + x1) / 2)
    s = _medfilt(s, min(len(s) - len(s) % 2 + 1, 13))
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    x[1:] = x[:-1] * 0.8 + x[1:] * 0.2
    y[1:] = y[:-1] * 0.8 + y[1:] * 0.2
    return {"x": x, "y": y, "s": np.asarray(s, dtype=np.float64)}


def _span(lo: int, hi: int, n: int):
    """numpy's [lo:hi] of a length-n axis as (start, stop)."""
    start, stop, _ = slice(lo, hi).indices(n)
    return start, max(start, stop)


def square_window(h: int, w: int, cx: float, cy: float,
                  half: float) -> List[int]:
    """The JAX package's square crop around (cx, cy) (``crop_face_square``:
    the frame padded by int(1.8 half) on every side, then cut at the
    truncated corners with numpy's slicing) as a box x1, y1, x2, y2 in the
    frame's coordinates, reaching outside it where the padding shows."""
    cs = 0.4
    bsi = int(half * (1 + 2 * cs))
    my, mx = cy + bsi, cx + bsi
    y1, y2 = _span(int(my - half), int(my + half * (1 + 2 * cs)),
                   h + 2 * bsi)
    x1, x2 = _span(int(mx - half * (1 + cs)), int(mx + half * (1 + cs)),
                   w + 2 * bsi)
    return [x1 - bsi, y1 - bsi, x2 - bsi, y2 - bsi]


def crop_faces_square(frames: Sequence[torch.Tensor], windows,
                      flip: bool = False) -> torch.Tensor:
    """(n, 112, 112) uint8 grey faces: each RGB frame converted to grey,
    cut to its :func:`square_window`, resized to 224 and cut to its centre
    112, in one ``crop_resize`` launch on the card."""
    faces = crop_resize(frames, np.asarray(windows, np.float32),
                        2 * CROP_SIZE, grey=True, flip=flip, fill=PAD_VALUE)
    h = CROP_SIZE
    return faces[:, h - h // 2:h + h // 2, h - h // 2:h + h // 2, 0]


def crop_face_square(img: torch.Tensor, cx: float, cy: float,
                     half: float) -> torch.Tensor:
    """One frame's (112, 112) grey square crop (the JAX package's
    ``crop_face_square``, of an RGB frame here): :func:`crop_faces_square`
    of one."""
    return crop_faces_square([img], [square_window(
        img.shape[0], img.shape[1], cx, cy, half)])[0]


def rotation_matrix(center, angle: float, scale: float = 1.0) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3), ``angle`` in degrees,
    counter-clockwise."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def warp_affine(images: torch.Tensor, matrix: np.ndarray) -> torch.Tensor:
    """cv2.warpAffine(image, matrix, (w, h)) of each (h, w) uint8 image of
    ``images`` (n, h, w), bilinear, zero outside, on their device: each
    output pixel reads the source at the inverse map of its position, its
    taps weighted in float32, rounded to nearest. cv2 quantizes the
    position to 1/32 pixel and the weights to 15 bits, so a pixel can
    land one or two values apart (the measured gap is in the tests)."""
    n, h, w = images.shape
    m = np.asarray(matrix, np.float64)
    inv = np.linalg.inv(np.vstack([m, [0.0, 0.0, 1.0]]))[:2]
    inv = torch.tensor(inv, dtype=torch.float64, device=images.device)
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=images.device),
        torch.arange(w, dtype=torch.float64, device=images.device),
        indexing="ij")
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    x0, y0 = sx.floor(), sy.floor()
    fx, fy = (sx - x0).float(), (sy - y0).float()
    x0, y0 = x0.long(), y0.long()
    src = images.float()

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = src[:, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        return torch.where(inside, v, torch.zeros((), device=src.device))

    out = ((tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx) * (1 - fy)
           + (tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx) * fy)
    return out.round().clamp(0, 255).to(torch.uint8)


class AsdTrialDataset(BucketedDataset):
    """Per-trial variable-length MFCC, grey faces and frame labels.

    ``get_item(idx, n)``: ``mfcc`` (4n, 13) float32, ``faces`` (n, 112,
    112) uint8 on the device (TalkNet normalizes them), ``labels`` (n,),
    ``trackid``; ``with_rgb`` adds the TTM-style streams of the same track,
    ``frames`` (n, S, S, 3) normalized float32 face crops at ``rgb_size``
    on the device and ``audio``, the raw normalized wave (the EgoT2-g and
    2-loader inputs)."""

    def __init__(self, root: str, split: str = "train",
                 augment: Optional[bool] = None, seed: int = 0,
                 with_rgb: bool = False, rgb_size: int = 224, device=None):
        # per-item generators from (seed, idx): the loader's threads call
        # get_item concurrently
        self.root = root
        self.with_rgb = with_rgb
        self.rgb_size = rgb_size
        self.augment = (split == "train") if augment is None else augment
        self.seed = seed
        self.device = resolve_device(device)
        self.trials = []
        with open(os.path.join(root, "csv", f"active_speaker_{split}.csv")) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split("\t")
                self.trials.append({
                    "trackid": parts[0], "num_frames": int(parts[1]),
                    "fps": float(parts[2]),
                    "labels": np.asarray([int(v) for v in
                                          parts[3].strip("[]").split(",")],
                                         dtype=np.int64),
                    "start": int(parts[-1])})
        self._wave_cache: Dict[str, tuple] = {}

    def __len__(self) -> int:
        return len(self.trials)

    @property
    def lengths(self) -> np.ndarray:
        return np.asarray([t["num_frames"] for t in self.trials])

    def _read_wave(self, uid: str):
        if uid not in self._wave_cache:
            from scipy.io import wavfile

            sr, wave = wavfile.read(os.path.join(self.root, "wave",
                                                 uid + ".wav"))
            if wave.ndim > 1:
                wave = wave.mean(axis=1)
            self._wave_cache[uid] = (sr, wave)
        return self._wave_cache[uid]

    def _trial_wave(self, trial) -> np.ndarray:
        sr, wave = self._read_wave(trial["trackid"][:36])
        start = trial["start"] / trial["fps"]
        end = (trial["start"] + trial["num_frames"]) / trial["fps"]
        return wave[int(start * sr):int(end * sr)], sr, start, end

    def _load_audio(self, trial, n_frames: int, with_aug: bool,
                    rng: np.random.Generator) -> np.ndarray:
        audio, sr, start, end = self._trial_wave(trial)
        if len(audio) == 0:
            audio = np.zeros(int(end * sr) - int(start * sr))
        audio = normalize_audio_int16(audio.astype(np.float64))
        if with_aug and rng.integers(0, 2) == 1 and len(self.trials) > 1:
            other = self.trials[int(rng.integers(0, len(self.trials)))]
            noise = normalize_audio_int16(
                self._trial_wave(other)[0].astype(np.float64))
            if len(noise):
                audio = overlap_noise(audio, noise, float(rng.uniform(-5, 5)))
        fps = trial["fps"]
        return mfcc_np(audio, 16000, winlen=0.025 * 25 / fps,
                       winstep=0.010 * 25 / fps,
                       num_frames=4 * n_frames).astype(np.float32)

    def _track(self, trial, n_frames: int):
        """The track's boxes in its span, and the (box index, decoded
        frame) of the first ``n_frames`` of them whose frame exists."""
        trackid = trial["trackid"]
        with open(os.path.join(self.root, "bbox", trackid + ".json")) as f:
            bbox = {b["frame"]: b for b in json.load(f)}
        boxes = [bbox[i] for i in range(trial["start"],
                                        trial["start"] + trial["num_frames"])
                 if i in bbox]
        decoded = []
        for k, b in enumerate(boxes):
            if len(decoded) >= n_frames:
                break
            path = os.path.join(self.root, "imgs", trackid[:36],
                                f"img_{int(b['frame']):05d}.jpg")
            if os.path.exists(path):
                decoded.append((k, read_jpeg(path, self.device)))
        return boxes, decoded

    def _load_visual(self, boxes, decoded, n_frames: int, with_aug: bool,
                     rng: np.random.Generator) -> torch.Tensor:
        out = torch.zeros((n_frames, CROP_SIZE, CROP_SIZE), dtype=torch.uint8,
                          device=self.device)
        if not boxes:
            return out
        dets = smooth_dets(boxes)
        aug = "orig"
        if with_aug:
            h = CROP_SIZE
            new = int(h * rng.uniform(0.7, 1))
            ax, ay = int(rng.integers(0, h - new)), int(rng.integers(0, h - new))
            rot = rotation_matrix((h / 2, h / 2), float(rng.uniform(-15, 15)))
            aug = AUGMENTS[int(rng.integers(0, 4))]
        if not decoded:
            return out
        windows = [square_window(img.shape[0], img.shape[1], dets["x"][k],
                                 dets["y"][k], dets["s"][k])
                   for k, img in decoded]
        faces = crop_faces_square([img for _, img in decoded], windows,
                                  flip=aug == "flip")
        if aug == "crop":
            faces = crop_resize(list(faces), np.asarray(
                [[ax, ay, ax + new, ay + new]] * len(faces), np.float32),
                CROP_SIZE)[..., 0]
        elif aug == "rotate":
            faces = warp_affine(faces, rot)
        out[:len(faces)] = faces
        return out

    def get_item(self, idx: int, n_frames: int) -> Dict:
        trial = self.trials[idx]
        rng = np.random.default_rng([self.seed, idx])
        mfcc = self._load_audio(trial, n_frames, self.augment, rng)
        boxes, decoded = self._track(trial, n_frames)
        labels = trial["labels"][:n_frames]
        if len(labels) < n_frames:
            labels = np.pad(labels, (0, n_frames - len(labels)), mode="edge")
        item = {"mfcc": mfcc,
                "faces": self._load_visual(boxes, decoded, n_frames,
                                           self.augment, rng),
                "labels": labels, "trackid": trial["trackid"]}
        if self.with_rgb:
            item["frames"] = self._load_rgb(boxes, decoded, n_frames)
            item["audio"] = self._load_wave_slice(trial, n_frames)
        return item

    def _load_rgb(self, boxes, decoded, n_frames: int) -> torch.Tensor:
        """TTM-style normalized RGB box crops (n, S, S, 3), the boxes'
        corners truncated to ints."""
        s = self.rgb_size
        out = torch.zeros((n_frames, s, s, 3), dtype=torch.uint8,
                          device=self.device)
        if decoded:
            crops = [[int(b["x"]), int(b["y"]), int(b["x"] + b["width"]),
                      int(b["y"] + b["height"])]
                     for b in (boxes[k] for k, _ in decoded)]
            out[:len(decoded)] = crop_resize(
                [img for _, img in decoded], np.asarray(crops, np.float32), s)
        return normalize(out)

    def _load_wave_slice(self, trial, n_frames: int) -> np.ndarray:
        sr, wave = self._read_wave(trial["trackid"][:36])
        onset = int(trial["start"] / trial["fps"] * sr)
        n_samples = int(n_frames / trial["fps"] * 16000)
        audio = wave[onset:onset + n_samples].astype(np.float64)
        if len(audio) < n_samples:
            audio = np.pad(audio, (0, n_samples - len(audio)))
        return normalize_audio_int16(audio)


class AsdSeqDataset(AsdTrialDataset):
    """EgoT2-g per-frame token targets: ``target_seq`` (n, 3), [<asd>,
    <label_t>, </s>] a frame."""

    def __init__(self, vocab, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.vocab = vocab

    def get_item(self, idx: int, n_frames: int) -> Dict:
        item = super().get_item(idx, n_frames)
        item["target_seq"] = np.stack([
            np.asarray([self.vocab["asd"], self.vocab[str(int(lab))],
                        self.vocab["</s>"]], dtype=np.int64)
            for lab in item["labels"]])
        return item

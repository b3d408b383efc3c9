"""Synthetic fixture trees in the reference's on-disk layouts.

Counterpart of ``egot2x/data/synthetic.py``'s HHI writers: the same trees
and, from the same seed, the same pixels before encoding (the same numpy
draws in the same order), the same tracks, boxes, labels and waves. The
frames are written as JPEGs on ``device``: by nvJPEG's encoder on the card,
by ``cv2.imwrite`` on the CPU (which writes the JAX package's files byte
for byte). The CLIs' ``--synthetic`` trees go under their own temporary
names, ``egot2x_torch_{lam,ttm,asd}_fixture``.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import List

import numpy as np

from egot2x_torch.core.registry import resolve_device
from egot2x_torch.data.image import write_jpeg


def fixture_root(task: str) -> str:
    """The temporary directory of the CLIs' ``--synthetic`` tree."""
    return os.path.join(tempfile.gettempdir(), f"egot2x_torch_{task}_fixture")


def _write_bgr(path: str, img: np.ndarray, device) -> None:
    """Write a cv2-ordered (BGR) array as the JAX package's cv2.imwrite
    does: its RGB is the array reversed on the channel axis."""
    write_jpeg(path, img[..., ::-1], device)


def make_lam_fixture(root: str, n_videos: int = 2, n_tracks: int = 2,
                     n_frames: int = 12, img_size: int = 64, seed: int = 0,
                     device=None) -> str:
    """A miniature LAM tree: imgs/, json/, gt/, train.list, val.list."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    uids: List[str] = []
    for v in range(n_videos):
        uid = f"vid{v:03d}"
        uids.append(uid)
        img_dir = os.path.join(root, "imgs", uid)
        json_dir = os.path.join(root, "json", uid)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(json_dir, exist_ok=True)
        h = w = img_size * 2
        for i in range(1, n_frames + 1):
            img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            _write_bgr(os.path.join(img_dir, f"img_{i:05d}.jpg"), img, device)
        for t in range(n_tracks):
            track = []
            for i in range(1, n_frames + 1):
                if i % 5 == 0 and t == 0:
                    continue  # a gap for the box interpolation
                track.append({"frameNumber": i,
                              "x": float(5 + t * 10 + rng.integers(0, 3)),
                              "y": float(5 + rng.integers(0, 3)),
                              "width": float(img_size // 2),
                              "height": float(img_size // 2),
                              "Person ID": f"p{t}"})
            with open(os.path.join(json_dir, f"track{t}.json"), "w") as f:
                json.dump(track, f)
        os.makedirs(os.path.join(root, "gt"), exist_ok=True)
        # one positive GT segment a video (track 0's person)
        with open(os.path.join(root, "gt", uid + ".json"), "w") as f:
            json.dump([{"start_frame": 2, "end_frame": n_frames // 2,
                        "label": "p0"}], f)
    _write_lists(root, uids, max(1, n_videos // 2))
    return root


def _write_lists(root: str, uids: List[str], split: int) -> None:
    with open(os.path.join(root, "train.list"), "w") as f:
        f.write("\n".join(uids[:split]) + "\n")
    with open(os.path.join(root, "val.list"), "w") as f:
        f.write("\n".join(uids[split:] or uids[:1]) + "\n")


def make_ttm_fixture(root: str, n_videos: int = 2, n_segments: int = 6,
                     img_size: int = 64, sample_rate: int = 16000,
                     seed: int = 0, seg_lens=None, label_signal: float = 0.0,
                     device=None) -> str:
    """A miniature TTM tree: imgs/, json/, gt/, wave/, train.list,
    val.list. Frames are (2 img_size)^2 with one face track of
    img_size^2 boxes; positive segments carry 'tags'. The default segment
    lengths span several buckets, one longer than 150 frames;
    ``seg_lens`` sets them; ``label_signal`` adds a per-segment brightness
    offset (+ for positive segments) that makes the labels learnable."""
    from scipy.io import wavfile

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    uids = []
    for v in range(n_videos):
        uid = f"tvid{v:03d}"
        uids.append(uid)
        img_dir = os.path.join(root, "imgs", uid)
        json_dir = os.path.join(root, "json", uid)
        for d in (img_dir, json_dir, os.path.join(root, "gt"),
                  os.path.join(root, "wave")):
            os.makedirs(d, exist_ok=True)
        lens = (list(seg_lens) if seg_lens is not None
                else [18, 40, 70, 100, 160, 25][:n_segments])
        total_frames = sum(lens) + 10
        offset = np.zeros(total_frames + 2, np.float32)
        if label_signal:
            pos = 1
            for s, ln in enumerate(lens):
                offset[pos:pos + ln] = (1.0 if s % 2 == 0 else -1.0) * (
                    label_signal)
                pos += ln
        h = w = img_size * 2
        for i in range(1, total_frames + 1):
            img = rng.integers(0, 255, (h, w, 3))
            if label_signal:
                img = img * 0.3 + 128.0 + offset[i]
            img = np.clip(img, 0, 255).astype(np.uint8)
            _write_bgr(os.path.join(img_dir, f"img_{i:05d}.jpg"), img, device)
        track = [{"frameNumber": i, "x": 4.0, "y": 4.0,
                  "width": float(img_size), "height": float(img_size),
                  "Person ID": "1"} for i in range(1, total_frames + 1)]
        with open(os.path.join(json_dir, "track0.json"), "w") as f:
            json.dump(track, f)
        gts, start = [], 1
        for s, ln in enumerate(lens):
            seg = {"label": "1", "start_frame": start,
                   "end_frame": start + ln - 1}
            if s % 2 == 0:
                seg["tags"] = ["person_x"]
            gts.append(seg)
            start += ln
        with open(os.path.join(root, "gt", uid + ".json"), "w") as f:
            json.dump(gts, f)
        wave = make_wave(int(total_frames / 30.0 * sample_rate) + sample_rate,
                         seed=seed + v)
        wavfile.write(os.path.join(root, "wave", uid + ".wav"), sample_rate,
                      (wave * 32767).astype(np.int16))
    _write_lists(root, uids, max(1, n_videos // 2))
    return root


def make_asd_fixture(root: str, n_videos: int = 2, n_tracks: int = 3,
                     img_size: int = 64, sample_rate: int = 16000,
                     seed: int = 0, device=None) -> str:
    """A miniature ASD tree: csv/, bbox/, wave/, imgs/ (TalkNet's layout);
    trackids start with their 36-character video uid."""
    from scipy.io import wavfile

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    for d in ("csv", "bbox", "wave"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rows_train, rows_val = [], []
    for v in range(n_videos):
        uid = f"avid{v:03d}".ljust(36, "x")
        img_dir = os.path.join(root, "imgs", uid)
        os.makedirs(img_dir, exist_ok=True)
        track_lens = [20, 35, 70][:n_tracks]
        total_frames = sum(track_lens) + 10
        h = w = img_size * 2
        for i in range(1, total_frames + 1):
            img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            _write_bgr(os.path.join(img_dir, f"img_{i:05d}.jpg"), img, device)
        fps = 30.0
        wave = make_wave(int(total_frames / fps * sample_rate) + sample_rate,
                         seed=seed + v)
        wavfile.write(os.path.join(root, "wave", uid + ".wav"), sample_rate,
                      (wave * 32767).astype(np.int16))
        start = 1
        for t, ln in enumerate(track_lens):
            trackid = f"{uid}:track{t}"
            bbox = [{"frame": i, "x": 8.0 + rng.integers(0, 3),
                     "y": 8.0 + rng.integers(0, 3), "width": float(img_size),
                     "height": float(img_size)}
                    for i in range(start, start + ln)]
            with open(os.path.join(root, "bbox", trackid + ".json"), "w") as f:
                json.dump(bbox, f)
            labels = rng.integers(0, 2, ln).tolist()
            row = "\t".join([trackid, str(ln), str(fps), str(labels), "extra",
                             str(start)])
            (rows_train if v < max(1, n_videos // 2) else rows_val).append(row)
            start += ln
    with open(os.path.join(root, "csv", "active_speaker_train.csv"), "w") as f:
        f.write("\n".join(rows_train) + "\n")
    with open(os.path.join(root, "csv", "active_speaker_val.csv"), "w") as f:
        f.write("\n".join(rows_val or rows_train) + "\n")
    return root


def make_wave(n_samples: int, seed: int = 0) -> np.ndarray:
    """Synthetic audio: a few random sinusoids + noise, float32 in
    [-1, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / 16000.0
    wave = sum(rng.uniform(0.05, 0.3)
               * np.sin(2 * np.pi * rng.uniform(80, 4000) * t)
               for _ in range(4))
    wave = wave + 0.01 * rng.standard_normal(n_samples)
    return wave.astype(np.float32)

"""TTM (talking-to-me) data: the segment index, face crops and audio.

Counterpart of ``egot2x/data/ttm.py``: ``make_dataset`` reads the GT
segments (label 1 where 'tags' is present; train drops segments shorter
than 15 frames; longer than 150 frames split into 150-frame chunks that
share their annotation's idx), ``get_bbox`` the interpolated face boxes;
an item is a segment's first n frames (its bucket's base) as face crops
resized to ``img_size``, and the first n / 30 s of its wave, RMS-normalized
to 0.1. Frames are decoded and cropped on the item's device by the data
plane (``data/image.py``), whose resize is within 2 of the JAX package's
``cv2.resize``; audio is host numpy through ``scipy.io.wavfile``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from egot2x_torch.core.registry import resolve_device
from egot2x_torch.data.bucketing import BucketedDataset
from egot2x_torch.data.image import crop_resize, normalize, read_jpeg
from egot2x_torch.data.lam import interpolate_track

FPS = 30.0


def normalize_audio(samples: np.ndarray, desired_rms: float = 0.1,
                    eps: float = 1e-4) -> np.ndarray:
    rms = max(eps, float(np.sqrt(np.mean(samples ** 2))))
    return (samples * (desired_rms / rms)).astype(np.float32)


def get_bbox(uid: str, json_path: str) -> Dict[str, tuple]:
    """"frame:personid" -> the interpolated box (x1, y1, x2, y2)."""
    bboxes: Dict[str, tuple] = {}
    for t in sorted(glob.glob(os.path.join(json_path, uid, "*.json"))):
        with open(t) as j:
            frames = json.load(j)
        frames.sort(key=lambda x: x["frameNumber"])
        for fr in interpolate_track(frames):
            bboxes[f"{fr['frameNumber']}:{fr['Person ID']}"] = (
                fr["x"], fr["y"], fr["x"] + fr["width"],
                fr["y"] + fr["height"])
    return bboxes


def make_dataset(file_list: str, img_anno: str, audio_anno: str,
                 min_frames: int = 15, max_frames: int = 150,
                 is_train: Optional[bool] = None
                 ) -> Tuple[List[list], Dict[str, Dict[str, tuple]]]:
    """Segments [uid, personid, label, start, end, idx] and face boxes."""
    if is_train is None:
        is_train = "train" in os.path.basename(file_list)
    face_crop: Dict[str, Dict[str, tuple]] = {}
    segments: List[list] = []
    with open(file_list) as f:
        uids = [line.strip() for line in f if line.strip()]
    for uid in uids:
        face_crop[uid] = get_bbox(uid, img_anno)
        with open(os.path.join(audio_anno, uid + ".json")) as js:
            gts = json.load(js)
        for idx, gt in enumerate(gts):
            personid = gt["label"]
            label = 1 if "tags" in gt else 0
            start, end = int(gt["start_frame"]), int(gt["end_frame"])
            seg_length = end - start + 1
            if ((is_train and seg_length < min_frames) or seg_length <= 1
                    or personid == 0):
                continue
            if seg_length <= max_frames:
                segments.append([uid, personid, label, start, end, idx])
                continue
            for i in range(int(seg_length / max_frames)):
                sub_start = start + i * max_frames
                sub_end = min(end, sub_start + max_frames)
                if sub_end - sub_start + 1 >= min_frames:
                    segments.append([uid, personid, label, sub_start,
                                     sub_end, idx])
    return segments, face_crop


def read_wave(path: str) -> np.ndarray:
    """A wav file as float32 mono in [-1, 1]: integer samples over their
    type's maximum, channels averaged."""
    from scipy.io import wavfile

    sr, wave = wavfile.read(path)
    if wave.dtype.kind == "i":
        wave = wave.astype(np.float32) / np.iinfo(wave.dtype).max
    if wave.ndim > 1:
        wave = wave.mean(axis=1)
    return sr, wave.astype(np.float32)


def audio_slice(wave: np.ndarray, start: int, n_frames: int,
                sample_rate: int) -> np.ndarray:
    """n_frames / 30 s of ``wave`` from frame ``start``, zero-padded,
    RMS-normalized."""
    onset = int(start / FPS * sample_rate)
    n_samples = int(n_frames / FPS * sample_rate)
    audio = wave[onset:onset + n_samples]
    if len(audio) < n_samples:
        audio = np.pad(audio, (0, n_samples - len(audio)))
    return normalize_audio(audio)


class TtmSegmentDataset(BucketedDataset):
    """Variable-length TTM segments, truncated to their bucket.

    ``get_item(idx, n)``: ``frames`` (n, S, S, 3) normalized float32 on the
    device (frames without a box or a file are zeros; a segment shorter
    than n repeats its last frame), ``audio`` (n / 30 * sr,) float32,
    ``label``, ``seg_id`` "uid:idx", ``start``, ``end``."""

    def __init__(self, root: str, split: str = "train", img_size: int = 224,
                 sample_rate: int = 16000, device=None):
        self.root = root
        self.img_path = os.path.join(root, "imgs")
        self.wave_path = os.path.join(root, "wave")
        self.img_size = img_size
        self.sample_rate = sample_rate
        self.device = resolve_device(device)
        self.segments, self.face_crop = make_dataset(
            os.path.join(root, f"{split}.list"), os.path.join(root, "json"),
            os.path.join(root, "gt"), is_train=(split == "train"))
        self._wave_cache: Dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.segments)

    @property
    def lengths(self) -> np.ndarray:
        return np.asarray([s[4] - s[3] + 1 for s in self.segments])

    def _read_wave(self, uid: str) -> np.ndarray:
        if uid not in self._wave_cache:
            sr, wave = read_wave(os.path.join(self.wave_path, uid + ".wav"))
            assert sr == self.sample_rate, (
                f"expected {self.sample_rate}Hz, got {sr}")
            self._wave_cache[uid] = wave
        return self._wave_cache[uid]

    def _decode(self, uid: str, frame_ids) -> Dict[int, torch.Tensor]:
        """The decoded frames of ``frame_ids`` that exist, by id."""
        out = {}
        for i in frame_ids:
            path = os.path.join(self.img_path, uid, f"img_{i:05d}.jpg")
            if i not in out and os.path.exists(path):
                out[i] = read_jpeg(path, self.device)
        return out

    def _faces(self, uid, personid, start, n_frames, decoded) -> torch.Tensor:
        """(n_frames, S, S, 3) uint8 face crops: each frame's box, its
        corners truncated to ints as the JAX loader's are."""
        s = self.img_size
        out = torch.zeros((n_frames, s, s, 3), dtype=torch.uint8,
                          device=self.device)
        crops = self.face_crop[uid]
        frames, boxes, slots = [], [], []
        for j, i in enumerate(range(start, start + n_frames)):
            key = f"{i}:{personid}"
            if key in crops and i in decoded:
                frames.append(decoded[i])
                boxes.append([int(v) for v in crops[key]])
                slots.append(j)
        if frames:
            out[slots] = crop_resize(frames, np.asarray(boxes, np.float32), s)
        return out

    def _frame_ids(self, start: int, n: int, n_frames: int) -> range:
        """The frames an item decodes: the segment's first n."""
        return range(start, start + n)

    def get_item(self, idx: int, n_frames: int) -> Dict:
        uid, personid, label, start, end, ann_idx = self.segments[idx]
        n = min(n_frames, end - start + 1)
        decoded = self._decode(uid, self._frame_ids(start, n, n_frames))
        frames = self._faces(uid, personid, start, n, decoded)
        if n < n_frames:  # shorter than the smallest bucket: edge-pad
            frames = torch.cat([frames, frames[-1:].expand(
                n_frames - n, *frames.shape[1:])])
        item = {"frames": normalize(frames),
                "audio": audio_slice(self._read_wave(uid), start, n_frames,
                                     self.sample_rate),
                "label": np.int64(label), "seg_id": f"{uid}:{ann_idx}",
                "start": np.int64(start), "end": np.int64(end)}
        self._extend(item, idx, n_frames, decoded)
        return item

    def _extend(self, item, idx, n_frames, decoded) -> None:
        """More streams from the decoded frames (the 2-loader's)."""


class TtmTestDataset(BucketedDataset):
    """The challenge's test layout (the reference's test_ImagerLoader):
    <root>/<sid>/audio/aud.wav and <root>/<sid>/face/*.jpg, with a
    seg_info.json of frame counts and frame lists; long segments chunked
    as in training; faces resized whole to ``img_size``."""

    def __init__(self, data_path: str, seg_info_path: str,
                 img_size: int = 224, sample_rate: int = 16000,
                 min_frames: int = 15, max_frames: int = 150, device=None):
        self.data_path = data_path
        self.img_size = img_size
        self.sample_rate = sample_rate
        self.device = resolve_device(device)
        with open(seg_info_path) as f:
            self.seg_info = json.load(f)
        self.segments = []
        for sid in sorted(os.listdir(data_path)):
            if sid not in self.seg_info:
                continue
            n = int(self.seg_info[sid]["frame_num"])
            start, end = 0, n - 1
            if n <= max_frames:
                self.segments.append([sid, start, end])
                continue
            for i in range(int(n / max_frames)):
                s = start + i * max_frames
                e = min(end, s + max_frames)
                if e - s + 1 >= min_frames:
                    self.segments.append([sid, s, e])
        self._wave_cache: Dict[str, np.ndarray] = {}

    def __len__(self):
        return len(self.segments)

    @property
    def lengths(self) -> np.ndarray:
        return np.asarray([e - s + 1 for _, s, e in self.segments])

    def _read_wave(self, sid: str) -> np.ndarray:
        if sid not in self._wave_cache:
            self._wave_cache[sid] = read_wave(os.path.join(
                self.data_path, sid, "audio", "aud.wav"))[1]
        return self._wave_cache[sid]

    def get_item(self, idx: int, n_frames: int) -> Dict:
        sid, start, end = self.segments[idx]
        s = self.img_size
        frames = torch.zeros((n_frames, s, s, 3), dtype=torch.uint8,
                             device=self.device)
        face_dir = os.path.join(self.data_path, sid, "face")
        frame_list = self.seg_info[sid].get("frame_list", [])
        if os.path.isdir(face_dir):
            files = sorted(os.listdir(face_dir))
            for j, i in enumerate(range(start, min(start + n_frames,
                                                   end + 1))):
                if i < len(files):
                    img = read_jpeg(os.path.join(face_dir, files[i]),
                                    self.device)
                    h, w = img.shape[:2]
                    frames[j] = crop_resize(
                        [img], np.asarray([[0, 0, w, h]], np.float32), s)[0]
        fids = (frame_list[start:start + n_frames] if frame_list
                else list(range(start, start + n_frames)))
        return {"frames": normalize(frames),
                "audio": audio_slice(self._read_wave(sid), start, n_frames,
                                     self.sample_rate),
                "seg_id": f"{sid}:{start}", "sid": sid,
                "start": np.int64(start), "end": np.int64(end),
                "frame_ids": ",".join(str(f) for f in fids)}


class TtmSeqDataset(TtmSegmentDataset):
    """EgoT2-g target tokens: ``target_seq`` [<ttm>, <label>, </s>]."""

    def __init__(self, vocab, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.vocab = vocab

    def get_item(self, idx: int, n_frames: int) -> Dict:
        item = super().get_item(idx, n_frames)
        item["target_seq"] = np.asarray(
            [self.vocab["ttm"], self.vocab[str(int(item["label"]))],
             self.vocab["</s>"]], dtype=np.int64)
        return item

"""LAM (looking-at-me) data: the index, 7-frame face clips, strips.

Counterpart of ``egot2x/data/lam.py``: ``make_dataset`` scans the GT and
track JSONs (boxes linearly interpolated over frame gaps by
``interpolate_track``); an item is the 7-frame window [f - 3, f + 3] of a
keyframe's face, each frame cropped to its track's box (widened by
``scale``) and resized to ``img_size``. The frames are decoded and cropped
by the data plane on the item's device (``data/image.py``: nvJPEG and the
``crop_resize`` kernel on the card, cv2 and the plain version on the CPU)
with the JAX package's native plane's arithmetic and float32 boxes, so a
whole window's pixels are the JAX loader's bit for bit. Where frames of the
window are missing, the JAX loader leaves its native plane for cv2 and
edge-pads (``pad_video``); the port crops the frames it has on the same
plane and edge-pads the same way.

On-disk layout (docs/PREPARE_HHI.md):
  <root>/json/<uid>/<trackid>.json    face tracklets (frameNumber, x, y,
                                      width, height, "Person ID")
  <root>/gt/<uid>.json                GT segments (start/end_frame, label)
  <root>/imgs/<uid>/img_%05d.jpg      full frames
  <root>/{train,val}.list             uid lists
"""

from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

from egot2x_torch.core.registry import resolve_device
from egot2x_torch.data import image
from egot2x_torch.data.image import (crop_resize, normalize, read_jpeg,
                                     write_jpeg)
from egot2x_torch.data.pipeline import Dataset

IMAGENET_MEAN = np.array(image.IMAGENET_MEAN, dtype=np.float32)
IMAGENET_STD = np.array(image.IMAGENET_STD, dtype=np.float32)


def normalize_frames(video_u8: np.ndarray) -> np.ndarray:
    """ToTensor + ImageNet Normalize of uint8 (..., 3) RGB frames, f32."""
    x = video_u8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def interpolate_track(frames: List[dict]) -> List[dict]:
    """Drop degenerate boxes and linearly interpolate box corners across
    frame gaps (the reference's ``check``)."""
    framenum, bboxes = [], []
    for fr in frames:
        w, h = fr["width"], fr["height"]
        if (w <= 0 or h <= 0 or fr["frameNumber"] == 0
                or len(fr["Person ID"]) == 0):
            continue
        x, y = max(fr["x"], 0), max(fr["y"], 0)
        framenum.append(fr["frameNumber"])
        bboxes.append([x, y, x + w, y + h])
    if not framenum:
        return []
    framenum = np.asarray(framenum)
    bboxes = np.asarray(bboxes, dtype=np.float64)
    full = np.arange(framenum[0], framenum[-1] + 1)
    if len(full) > len(framenum):
        interp = np.stack([np.interp(full, framenum, bboxes[:, j])
                           for j in range(4)], axis=1)
    else:
        full, interp = framenum, bboxes
    out = []
    for f, bb in zip(full, interp):
        rec = dict(frames[0])
        rec["frameNumber"] = int(f)
        rec["x"], rec["y"] = bb[0], bb[1]
        rec["width"], rec["height"] = bb[2] - bb[0], bb[3] - bb[1]
        out.append(rec)
    return out


def make_dataset(file_name: str, json_path: str, gt_path: str,
                 stride: int = 1) -> Tuple[List[tuple], List[int]]:
    """The (uid, trackid, frameid, bbox, label) index and its keyframes
    (every ``stride``-th frame of a track)."""
    images: List[tuple] = []
    keyframes: List[int] = []
    with open(file_name) as f:
        uids = [line.strip() for line in f if line.strip()]
    for uid in uids:
        with open(os.path.join(gt_path, uid + ".json")) as f:
            gts = json.load(f)
        positive = {f"{i}:{gt['label']}" for gt in gts
                    for i in range(gt["start_frame"], gt["end_frame"] + 1)}
        for tpath in sorted(glob.glob(os.path.join(json_path, uid, "*.json"))):
            with open(tpath) as j:
                frames = json.load(j)
            frames.sort(key=lambda x: x["frameNumber"])
            trackid = os.path.basename(tpath)[:-5]
            for idx, fr in enumerate(interpolate_track(frames)):
                frameid = fr["frameNumber"]
                bbox = (fr["x"], fr["y"], fr["x"] + fr["width"],
                        fr["y"] + fr["height"])
                label = 1 if f"{frameid}:{fr['Person ID']}" in positive else 0
                if idx % stride == 0:
                    keyframes.append(len(images))
                images.append((uid, trackid, frameid, bbox, label))
    return images, keyframes


def pad_video(video: torch.Tensor) -> torch.Tensor:
    """Edge-pad the all-zero frames around the middle one: the kept frames
    in order, the first repeated for each padded frame before the middle,
    the last for each after it (the reference's ``pad_video``)."""
    pad = (video == 0).flatten(1).all(dim=1).cpu()
    mid = len(video) // 2
    pad[mid] = False
    kept = video[~pad.to(video.device)]
    front, back = int(pad[:mid].sum()), int(pad[mid + 1:].sum())
    return torch.cat([kept[:1].expand(front, *kept.shape[1:]), kept,
                      kept[-1:].expand(back, *kept.shape[1:])])


class LamClipDataset(Dataset):
    """7-frame face-crop clips + labels.

    Items: ``frames`` (7, S, S, 3) normalized float32 on the device,
    ``label`` int64, ``uid`` "uid:frameid:trackid", ``bbox`` (4,) float32.
    """

    def __init__(self, root: str, split: str = "train", stride: int = 1,
                 scale: float = 0.0, img_size: int = 224, window: int = 7,
                 device=None):
        self.root = root
        self.img_dir = os.path.join(root, "imgs")
        self.scale = scale
        self.img_size = img_size
        self.window = window
        self.device = resolve_device(device)
        self.imgs, self.kframes = make_dataset(
            os.path.join(root, f"{split}.list"), os.path.join(root, "json"),
            os.path.join(root, "gt"), stride)
        # uid -> track -> frame -> bbox
        self.img_group: Dict[str, Dict[str, Dict[int, tuple]]] = defaultdict(
            lambda: defaultdict(dict))
        for uid, trackid, frameid, bbox, _ in self.imgs:
            self.img_group[uid][trackid][frameid] = bbox

    def __len__(self) -> int:
        return len(self.kframes)

    def _load_clip(self, index: int) -> torch.Tensor:
        """(window, S, S, 3) uint8 RGB on the device."""
        uid, trackid, frameid, _, _ = self.imgs[self.kframes[index]]
        half, s = self.window // 2, self.scale
        track = self.img_group[uid][trackid]
        frames, boxes, slots = [], [], []
        for j, i in enumerate(range(frameid - half, frameid + half + 1)):
            path = os.path.join(self.img_dir, uid, f"img_{i:05d}.jpg")
            if i not in track or not os.path.exists(path):
                continue
            x1, y1, x2, y2 = track[i]
            frames.append(read_jpeg(path, self.device))
            boxes.append([(1.0 - s) * x1, (1.0 - s) * y1,
                          (1.0 + s) * x2, (1.0 + s) * y2])
            slots.append(j)
        size = self.img_size
        video = torch.zeros((self.window, size, size, 3), dtype=torch.uint8,
                            device=self.device)
        if frames:
            video[slots] = crop_resize(frames, np.asarray(boxes, np.float32),
                                       size)
        if len(slots) < self.window:
            video = pad_video(video)
        return video

    def __getitem__(self, index: int):
        video = self._load_clip(index)
        uid, trackid, frameid, bbox, label = self.imgs[self.kframes[index]]
        return {"frames": normalize(video), "label": np.int64(label),
                "uid": f"{uid}:{frameid}:{trackid}",
                "bbox": np.asarray(bbox, dtype=np.float32)}


def preprocess_lam_strips(root: str, split: str = "train", stride: int = 1,
                          scale: float = 0.0, img_size: int = 224,
                          device=None) -> str:
    """Write each keyframe's 7-frame window as one (7 S, S, 3) JPEG strip
    under <root>/imgs_processed/<uid>/img_%05d.jpg (the reference's
    NewImagerLoader.process_dataset): one JPEG read an item in training
    instead of seven. Encoded on ``device`` (nvJPEG on the card, cv2 on
    the CPU)."""
    ds = LamClipDataset(root, split=split, stride=stride, scale=scale,
                        img_size=img_size, device=device)
    out_root = os.path.join(root, "imgs_processed")
    for index in range(len(ds)):
        uid = ds.imgs[ds.kframes[index]][0]
        out_dir = os.path.join(out_root, uid)
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, f"img_{ds.kframes[index]:05d}.jpg")
        if os.path.exists(out_path):
            continue
        video = ds._load_clip(index)
        t, h, w, c = video.shape
        write_jpeg(out_path, video.reshape(t * h, w, c).cpu().numpy(),
                   ds.device)
    return out_root


class LamStripDataset(LamClipDataset):
    """Reads the preprocessed strips (the reference's NewImagerLoader);
    a missing strip is cut from the frames."""

    def __init__(self, *args, preprocess: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.strip_root = os.path.join(self.root, "imgs_processed")
        if preprocess:
            preprocess_lam_strips(self.root, kwargs.get("split", "train"),
                                  kwargs.get("stride", 1),
                                  kwargs.get("scale", 0.0), self.img_size,
                                  device=self.device)

    def _load_clip(self, index: int) -> torch.Tensor:
        uid = self.imgs[self.kframes[index]][0]
        path = os.path.join(self.strip_root, uid,
                            f"img_{self.kframes[index]:05d}.jpg")
        if os.path.exists(path):
            s = self.img_size
            return read_jpeg(path, self.device).reshape(self.window, s, s, 3)
        return super()._load_clip(index)


class LamTestDataset(Dataset):
    """The challenge's test layout (the reference's TestImagerLoader):
    <root>/<uid>/<trackid>/<frameid>_<uniqueid>.jpg face crops; 7-frame
    windows around each frame, edge-padded; crops of another size resized
    whole to ``img_size`` on the data plane."""

    def __init__(self, test_path: str, img_size: int = 224, stride: int = 1,
                 window: int = 7, device=None):
        self.test_path = test_path
        self.img_size = img_size
        self.window = window
        self.device = resolve_device(device)
        self.items = []  # (uid, trackid, uniqueid, frameid)
        self.track_files: Dict[tuple, Dict[int, str]] = {}
        for uid in sorted(os.listdir(test_path)):
            udir = os.path.join(test_path, uid)
            if not os.path.isdir(udir):
                continue
            for trackid in sorted(os.listdir(udir)):
                tdir = os.path.join(udir, trackid)
                if not os.path.isdir(tdir):
                    continue
                files = {}
                for idx, fname in enumerate(sorted(os.listdir(tdir))):
                    parts = os.path.splitext(fname)[0].split("_")
                    if len(parts) < 2:
                        continue
                    frameid = int(parts[0])
                    files[frameid] = os.path.join(tdir, fname)
                    if idx % stride == 0:
                        self.items.append((uid, trackid, parts[1], frameid))
                self.track_files[(uid, trackid)] = files

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int):
        uid, trackid, uniqueid, frameid = self.items[index]
        files = self.track_files[(uid, trackid)]
        half, s = self.window // 2, self.img_size
        video = torch.zeros((self.window, s, s, 3), dtype=torch.uint8,
                            device=self.device)
        for j, i in enumerate(range(frameid - half, frameid + half + 1)):
            if i not in files:
                continue
            img = read_jpeg(files[i], self.device)
            h, w = img.shape[:2]
            video[j] = img if (h, w) == (s, s) else crop_resize(
                [img], np.asarray([[0, 0, w, h]], np.float32), s)[0]
        if len(files.keys() & set(range(frameid - half,
                                        frameid + half + 1))) < self.window:
            video = pad_video(video)
        return {"frames": normalize(video),
                "uid": f"{uid}:{uniqueid}:{trackid}",
                "label": np.int64(0)}   # the test split is unlabeled


class LamSeqDataset(LamClipDataset):
    """Token-sequence targets for EgoT2-g (the reference's
    NewImagerSeqLoader): ``target_seq`` = [<lam>, <label>, </s>]."""

    def __init__(self, vocab, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.vocab = vocab

    def __getitem__(self, index: int):
        item = super().__getitem__(index)
        item["target_seq"] = np.asarray(
            [self.vocab["lam"], self.vocab[str(int(item["label"]))],
             self.vocab["</s>"]], dtype=np.int64)
        return item

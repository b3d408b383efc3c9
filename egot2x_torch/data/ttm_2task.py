"""TTM 2-loader data: the four input streams of the 3-task translator.

Counterpart of ``egot2x/data/ttm_2task.py``, the flagship's Stage-II feed.
Per segment, truncated to its bucket's n frames:

  * ``frames`` (n, S, S, 3): the TTM-style RGB face crops;
  * ``video_asd`` (n, 112, 112) uint8: the ASD-style grey square crops
    around the track's median-filtered sizes and smoothed centres;
  * ``audio``: the raw wave slice, RMS-normalized;
  * ``audio_asd`` (4n, 13): its MFCC with the fps-scaled window.

Each frame is decoded once on the item's device, and both crops come from
it: one ``crop_resize`` launch for the RGB faces and one for the grey
squares on the card (the JAX package reads every frame twice).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from egot2x_torch.audio.mfcc import mfcc_np
from egot2x_torch.data.asd import CROP_SIZE, crop_faces_square, smooth_dets
from egot2x_torch.data.asd import square_window
from egot2x_torch.data.ttm import FPS, TtmSegmentDataset


class TtmTwoTaskDataset(TtmSegmentDataset):
    def _frame_ids(self, start: int, n: int, n_frames: int) -> range:
        """The ASD stream reads the bucket's n frames of the track, past a
        shorter segment's end too (as the JAX package's does)."""
        return range(start, start + n_frames)

    def _asd_frames(self, uid, personid, start, n_frames,
                    decoded) -> torch.Tensor:
        crops = self.face_crop[uid]
        track = []
        for i in range(start, start + n_frames):
            key = f"{i}:{personid}"
            if key in crops:
                x1, y1, x2, y2 = crops[key]
                track.append({"frame": i, "x": x1, "y": y1,
                              "width": x2 - x1, "height": y2 - y1})
        out = torch.zeros((n_frames, CROP_SIZE, CROP_SIZE), dtype=torch.uint8,
                          device=self.device)
        if not track:
            return out
        dets = smooth_dets(track)
        kept = [(k, decoded[fr["frame"]]) for k, fr in enumerate(track)
                if fr["frame"] in decoded][:n_frames]
        if kept:
            windows = [square_window(img.shape[0], img.shape[1],
                                     dets["x"][k], dets["y"][k],
                                     dets["s"][k]) for k, img in kept]
            out[:len(kept)] = crop_faces_square([img for _, img in kept],
                                                windows)
        return out

    def _extend(self, item, idx, n_frames, decoded) -> None:
        uid, personid, _, start, _, _ = self.segments[idx]
        item["video_asd"] = self._asd_frames(uid, personid, start, n_frames,
                                             decoded)
        item["audio_asd"] = mfcc_np(
            item["audio"].astype(np.float64), 16000,
            winlen=0.025 * 25 / FPS, winstep=0.010 * 25 / FPS,
            num_frames=4 * n_frames).astype(np.float32)


class TtmTwoTaskSeqDataset(TtmTwoTaskDataset):
    """EgoT2-g target tokens for the 2-loader feed: ``target_seq`` [<ttm>,
    <label>, </s>]."""

    def __init__(self, vocab, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.vocab = vocab

    def get_item(self, idx: int, n_frames: int) -> Dict:
        item = super().get_item(idx, n_frames)
        item["target_seq"] = np.asarray(
            [self.vocab["ttm"], self.vocab[str(int(item["label"]))],
             self.vocab["</s>"]], dtype=np.int64)
        return item

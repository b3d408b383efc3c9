"""Host-side frame normalization (counterpart of ``egot2x/data/lam.py``)."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_frames(video_u8: np.ndarray) -> np.ndarray:
    """ToTensor + ImageNet Normalize of uint8 (..., 3) RGB frames, f32."""
    x = video_u8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD

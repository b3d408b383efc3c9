"""Write the reference JPEGs that ``chip_smoke.py`` decodes on the card.

Three small frames (smooth gradients and shapes with a little noise, as
camera frames are, not pure noise), encoded by ``cv2.imwrite`` at its
defaults (quality 95, 4:2:0 chroma) into ``tools/jpeg_refs/ref_<k>.jpg``,
the first once more with full-resolution chroma (4:4:4) as ``ref_3.jpg``,
and cv2's own decodes of those files, RGB, in ``tools/jpeg_refs/
decoded.npz`` (``ref_<k>``): the pixels a libjpeg decoder gives, which
nvJPEG's decode is held against (its IDCT rounding and its chroma
upsampling are not libjpeg's; a 4:4:4 file has no upsampling). Needs cv2,
so it runs on a machine that has it:

    python -m egot2x_torch.tools.make_jpeg_refs
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

REFS = Path(__file__).resolve().parent / "jpeg_refs"
SHAPES = ((96, 128), (120, 160), (64, 64))   # (h, w) of each frame
FULL_CHROMA = "ref_3"   # frame 0 at 4:4:4


def frame(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8 RGB: colour gradients, a disc and a bar, noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([255 * x / w, 255 * y / h, 128 + 100 * np.sin(x / 7)], -1)
    disc = (x - w * 0.6) ** 2 + (y - h * 0.4) ** 2 < (min(h, w) / 4) ** 2
    img[disc] = (230, 40, 60)
    img[h // 2:h // 2 + 6, w // 8:w // 2] = (20, 200, 240)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> None:
    import cv2

    REFS.mkdir(exist_ok=True)
    decoded = {}
    full = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
    for k, (h, w) in enumerate(SHAPES + SHAPES[:1]):
        path = REFS / f"ref_{k}.jpg"
        cv2.imwrite(str(path), frame(h, w, k % len(SHAPES))[..., ::-1],
                    full if path.stem == FULL_CHROMA else [])
        decoded[path.stem] = cv2.imread(str(path))[..., ::-1]
    np.savez_compressed(REFS / "decoded.npz", **decoded)
    print({p.name: p.stat().st_size for p in sorted(REFS.iterdir())})


if __name__ == "__main__":
    main()

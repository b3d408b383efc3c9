"""The port's data plane on the CPU against the JAX package's.

``egot2x_torch/data/image.py::crop_resize`` takes its plain version here
(the CUDA kernel's twin, ``tests/test_torch_port_data_cuda.py``), and is
held to:

* ``egot2x.native.decode_crop_resize`` (the JAX package's C++ data plane,
  libjpeg + ``dataplane.cpp:73-130``), bit for bit on the same JPEGs and
  boxes, where that plane built: cv2's decode and libjpeg's give the same
  pixels, and the arithmetic is the same;
* ``cv2.resize`` (INTER_LINEAR; at exactly 2x down cv2 takes INTER_AREA,
  the same 2 x 2 mean), within 2 grey levels, the bar
  ``tests/test_native.py`` holds the JAX package's plane to, with the share
  of pixels that differ measured: up-scaling, a non-integer down-scale and
  an exact 2x down-scale, RGB and grey (cv2's COLOR_BGR2GRAY first, bit for
  bit), flipped, and an empty box (zeros);
* the ASD square crop: ``np.pad`` with 110, ``cvtColor``, ``cv2.resize``
  to 224 and the centre 112 (``egot2x/data/asd.py::crop_face_square``),
  within 2;
* the rotation, ``warp_affine``, against ``cv2.warpAffine`` at +-15
  degrees: within 2, the measured gap stated.

MFCC (``audio/mfcc.py::mfcc_np``) against ``egot2x/audio/mfcc.py`` on
``make_wave``, to 1e-6; ``normalize`` against ``normalize_frames`` bit for
bit. No JAX function is jitted here.
"""

import os

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from egot2x import native  # noqa: E402
from egot2x.audio.mfcc import mfcc_np as jax_mfcc_np  # noqa: E402
from egot2x.data.asd import crop_face_square  # noqa: E402
from egot2x.data.lam import normalize_frames  # noqa: E402
from egot2x.data.synthetic import make_wave  # noqa: E402
from egot2x_torch.audio.mfcc import mfcc_np  # noqa: E402
from egot2x_torch.data import image  # noqa: E402
from egot2x_torch.data.asd import crop_face_square as port_square  # noqa: E402
from egot2x_torch.data.asd import (rotation_matrix, square_window,  # noqa: E402
                                   warp_affine)
from test_torch_port_train import _one_thread  # noqa: E402,F401

# the bar tests/test_native.py holds the JAX package's plane to against
# cv2.resize
CV2_BAR = 2
# (frame h, w), box, out: up 2x, non-integer down (60.2 x 86.9 -> 45),
# exact 2x down (cv2's INTER_AREA case), whole frame, a box past the edge
CASES = [((64, 64), (5, 6, 37, 38), 64),
         ((96, 120), (10.7, 3.2, 97.1, 63.4), 45),
         ((128, 128), (0, 0, 128, 128), 64),
         ((50, 70), (0, 0, 70, 50), 224),
         ((80, 80), (60, 70, 95, 99), 32)]


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """One cv2-written JPEG a case, and each path."""
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    paths = []
    for k, ((h, w), _, _) in enumerate(CASES):
        path = str(d / f"{k}.jpg")
        cv2.imwrite(path, rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        paths.append(path)
    return paths


def _rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


def _ours(paths, boxes, size, **kw):
    frames = [image.read_jpeg(p, "cpu") for p in paths]
    return image.crop_resize(frames, np.asarray(boxes, np.float32), size,
                             **kw).numpy()


def _cv2_crop(img, box, size):
    x1, y1, x2, y2 = (int(np.float32(v)) for v in box)
    face = img[max(y1, 0):y2, max(x1, 0):x2]
    return cv2.resize(face, (size, size))


@pytest.mark.skipif(not native.AVAILABLE, reason="egot2x's native plane "
                    "did not build (no g++ or libjpeg)")
@pytest.mark.parametrize("case", range(len(CASES)))
def test_crop_resize_is_the_native_plane_bit_for_bit(jpegs, case):
    (_, box, size) = CASES[case]
    want = native.decode_crop_resize([jpegs[case]],
                                     np.asarray([box], np.float32), size)
    np.testing.assert_array_equal(_ours([jpegs[case]], [box], size), want)


@pytest.mark.parametrize("grey", [False, True], ids=["rgb", "grey"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_crop_resize_within_two_of_cv2(jpegs, case, grey):
    """Measured: at most 1 level off cv2.resize, on 0-13% of the pixels
    (none at the whole-frame 2x case)."""
    (_, box, size) = CASES[case]
    img = _rgb(jpegs[case])
    if grey:   # cv2's conversion of the BGR frame, then its resize
        img = cv2.cvtColor(cv2.imread(jpegs[case]), cv2.COLOR_BGR2GRAY)
    want = _cv2_crop(img, box, size)
    got = _ours([jpegs[case]], [box], size, grey=grey)
    got = got[0, ..., 0] if grey else got[0]
    diff = np.abs(got.astype(int) - want)
    assert diff.max() <= CV2_BAR, (diff.max(), (diff > 0).mean())


def test_grey_is_cv2s_conversion_bit_for_bit(jpegs):
    """A whole frame at its own size is the identity resize: what remains
    is the conversion, cv2's 14-bit weights exactly."""
    img = cv2.imread(jpegs[0])
    got = _ours([jpegs[0]], [(0, 0, 64, 64)], 64, grey=True)[0, ..., 0]
    np.testing.assert_array_equal(got, cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


def test_flip_mirrors_and_empty_boxes_are_zeros(jpegs):
    paths = [jpegs[1]] * 3
    boxes = [CASES[1][1], CASES[1][1], (40, 10, 40, 50)]
    plain = _ours(paths, boxes, 45)
    flipped = _ours(paths, boxes, 45, flip=[False, True, True])
    np.testing.assert_array_equal(flipped[1], plain[1][:, ::-1])
    np.testing.assert_array_equal(flipped[0], plain[0])
    assert not flipped[2].any() and not plain[2].any()


def test_square_crop_within_two_of_the_jax_package(jpegs):
    """``crop_face_square`` (pad 110, grey, resize to 224, centre 112) on
    a centre near the frame's edge, where the padding shows."""
    bgr = cv2.imread(jpegs[0])
    cx, cy, half = 20.4, 30.6, 24.0
    want = crop_face_square(bgr, cx, cy, half)
    assert square_window(*bgr.shape[:2], cx, cy, half)[0] < 0  # the pad
    got = port_square(image.read_jpeg(jpegs[0], "cpu"), cx, cy,
                      half).numpy()
    diff = np.abs(got.astype(int) - want)
    assert got.shape == (112, 112) and diff.max() <= CV2_BAR


def test_rotation_within_two_of_cv2():
    """cv2 5 warps with float coordinates and weights, as ``warp_affine``
    does. Measured over 8 faces at angles in +-15 degrees: at most 1 level
    off, on 0.02% of the pixels."""
    rng = np.random.default_rng(1)
    faces = rng.integers(0, 256, (8, 112, 112), dtype=np.uint8)
    for face, angle in zip(faces, rng.uniform(-15, 15, 8)):
        m = rotation_matrix((56.0, 56.0), float(angle))
        np.testing.assert_array_equal(
            m, cv2.getRotationMatrix2D((56.0, 56.0), float(angle), 1))
        want = cv2.warpAffine(face, m, (112, 112))
        got = warp_affine(torch.from_numpy(face)[None], m)[0].numpy()
        diff = np.abs(got.astype(int) - want)
        assert diff.max() <= CV2_BAR


def test_normalize_is_the_jax_packages():
    u8 = np.random.default_rng(2).integers(0, 256, (3, 7, 9, 3),
                                           dtype=np.uint8)
    np.testing.assert_array_equal(image.normalize(torch.from_numpy(u8)),
                                  normalize_frames(u8))


@pytest.mark.parametrize("fps", [25.0, 30.0])
def test_mfcc_matches_jax(fps):
    wave = make_wave(16000, seed=3).astype(np.float64)
    kw = dict(winlen=0.025 * 25 / fps, winstep=0.010 * 25 / fps,
              num_frames=120)
    np.testing.assert_allclose(mfcc_np(wave, 16000, **kw),
                               jax_mfcc_np(wave, 16000, **kw), rtol=1e-6,
                               atol=1e-6)


def test_the_card_routes_refuse_the_cpu(jpegs, tmp_path):
    """The device picks the route; nvJPEG's calls do not take the CPU."""
    with open(jpegs[0], "rb") as f:
        data = f.read()
    with pytest.raises(ValueError, match="card"):
        image.decode_jpeg(data, "cpu")
    with pytest.raises(ValueError, match="card"):
        image.encode_jpeg(torch.zeros(8, 8, 3, dtype=torch.uint8))
    path = str(tmp_path / "w.jpg")
    rgb = _rgb(jpegs[0])
    image.write_jpeg(path, rgb, "cpu")   # cv2 on the CPU
    assert os.path.getsize(path) > 0
    assert np.abs(_rgb(path).astype(int) - rgb).mean() < 8

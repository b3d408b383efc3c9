"""Card tests of the data plane: the hand-written ``crop_resize`` kernel
against its plain version bit for bit (RGB and grey frames, grey
conversion, flips, the fill value past the frame, empty boxes, boxes past
the edge, up- and down-scaling, frames of different sizes in one launch),
nvJPEG's decode of the committed cv2-written reference JPEGs against cv2's
decode (``chip_smoke.py``'s bars: 4:4:4 within 3 levels, 4:2:0 luma within
a mean of 1, every file's chroma averaged over 2x2 blocks within a mean of
3, which a Cb/Cr swap fails), the encode-decode round trip (luma mean
within 2, block chroma within 3), and the wrappers' refusals.

Marked ``cuda``; each test skips without a card. No JAX import: run it as
tests/test_torch_port_cuda.py is run, with ``--noconftest``.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from egot2x_torch.data import image  # noqa: E402

pytestmark = pytest.mark.cuda
REFS = Path(__file__).resolve().parents[1] / "egot2x_torch" / "tools" / (
    "jpeg_refs")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frames(rng, shapes, channels=3):
    return [torch.from_numpy(rng.integers(0, 256, (h, w, channels),
                                          dtype=np.uint8)) for h, w in shapes]


@pytest.mark.parametrize("size", [32, 45, 64, 224])
@pytest.mark.parametrize("grey", [False, True])
def test_crop_resize_kernel_matches_plain(cuda, size, grey):
    rng = np.random.default_rng(size)
    frames = _frames(rng, [(96, 128), (512, 512), (64, 64), (50, 70),
                           (80, 80)])
    boxes = np.float32([[10.7, 3.2, 97.1, 63.4], [4, 4, 260, 260],
                        [0, 0, 64, 64], [30, 10, 30, 40],   # empty
                        [60, 70, 95, 99]])                  # past the edge
    flip = [False, True, False, True, False]
    for fill in (None, 110):
        got = image.crop_resize([f.to(cuda) for f in frames], boxes, size,
                                grey=grey, flip=flip, fill=fill)
        torch.cuda.synchronize()
        want = image.crop_resize_plain(frames, boxes, size, grey=grey,
                                       flip=flip, fill=fill)
        assert got.shape == want.shape == (5, size, size, 1 if grey else 3)
        assert torch.equal(got.cpu(), want)
        assert not want[3].any()


def test_crop_resize_kernel_takes_grey_frames(cuda):
    rng = np.random.default_rng(7)
    frames = [f[..., 0] for f in _frames(rng, [(112, 112)] * 3)]
    boxes = np.float32([[5, 9, 100, 104]] * 3)
    got = image.crop_resize([f.to(cuda) for f in frames], boxes, 112)
    assert torch.equal(got.cpu(), image.crop_resize_plain(frames, boxes, 112))


def test_crop_resize_counts_and_refuses(cuda):
    frame = torch.zeros(8, 8, 3, dtype=torch.uint8, device=cuda)
    before = image.crop_resize.launches
    image.crop_resize([frame], np.float32([[0, 0, 8, 8]]), 4)
    assert image.crop_resize.launches == before + 1
    with pytest.raises(ValueError):
        image.crop_resize([frame.float()], np.float32([[0, 0, 8, 8]]), 4)
    with pytest.raises(ValueError):
        image.crop_resize([frame, frame.cpu()], np.float32([[0, 0, 8, 8]] * 2),
                          4)


def _luma(x):
    """BT.601 luma of uint8 RGB, cv2's 14-bit grey weights."""
    r, g, b = (x[..., k].astype(np.int64) for k in range(3))
    w = image.GREY
    return (r * w[0] + g * w[1] + b * w[2] + (1 << 13)) >> 14


def _chroma(x):
    """Cb and Cr (JFIF's BT.601) of uint8 RGB averaged over each 2x2 block,
    one 4:2:0 chroma sample's footprint: decoders that upsample chroma
    differently agree there but for colour edges."""
    h, w = x.shape[0] // 2 * 2, x.shape[1] // 2 * 2
    r, g, b = (x[:h, :w, k].astype(np.float64) for k in range(3))
    c = np.stack([128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
                  128 + 0.5 * r - 0.418688 * g - 0.081312 * b], -1)
    return c.reshape(h // 2, 2, w // 2, 2, 2).mean((1, 3))


@pytest.mark.parametrize("name", ["ref_0", "ref_1", "ref_2", "ref_3"])
def test_nvjpeg_decodes_libjpegs_image(cuda, name):
    """4:4:4 (ref_3): every channel within 3 levels of libjpeg's (the
    IDCT's rounding through the colour conversion); 4:2:0: the luma within
    a mean of 1 level (JFIF leaves chroma upsampling to the decoder, and
    luma takes none of it); every file: the 2x2 block chroma within a mean
    of 3 levels (measured on an H100: at most 1.45), which the decode with
    Cb and Cr swapped fails; an encode-decode round trip, luma mean within
    2 (q95), block chroma within 3."""
    want = np.load(REFS / "decoded.npz")[name]
    got = image.decode_jpeg((REFS / f"{name}.jpg").read_bytes(), cuda)
    assert got.is_cuda and got.dtype == torch.uint8
    got = got.cpu().numpy()
    assert got.shape == want.shape
    if name == "ref_3":
        assert np.abs(got.astype(np.int16) - want).max() <= 3
    else:
        assert np.abs(_luma(got) - _luma(want)).mean() <= 1.0
    assert np.abs(_chroma(got) - _chroma(want)).mean() <= 3.0
    assert np.abs(_chroma(got)[..., ::-1] - _chroma(want)).mean() > 3.0
    again = image.decode_jpeg(image.encode_jpeg(torch.from_numpy(
        want).to(cuda)), cuda).cpu().numpy()
    assert np.abs(_luma(again) - _luma(want)).mean() <= 2.0
    assert np.abs(_chroma(again) - _chroma(want)).mean() <= 3.0


def test_jpeg_files_round_trip_on_the_card(cuda, tmp_path):
    rgb = np.load(REFS / "decoded.npz")["ref_1"]
    path = str(tmp_path / "x.jpg")
    image.write_jpeg(path, rgb, cuda)
    got = image.read_jpeg(path, cuda)
    assert got.shape == rgb.shape and got.is_cuda
    assert np.abs(_luma(got.cpu().numpy()) - _luma(rgb)).mean() <= 2.0
    assert np.abs(_chroma(got.cpu().numpy()) - _chroma(rgb)).mean() <= 3.0


def test_data_plane_runs_on_the_named_card():
    """On a second card, from a new thread (whose current card is the
    first): the decode, the encode and the kernel run on the tensors' card
    and give what the first card gives."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from concurrent.futures import ThreadPoolExecutor

    data = (REFS / "ref_1.jpg").read_bytes()
    boxes = np.float32([[10.7, 3.2, 97.1, 63.4]])

    def run(device):
        img = image.decode_jpeg(data, device)
        again = image.decode_jpeg(image.encode_jpeg(img), device)
        out = image.crop_resize([img], boxes, 45, grey=True, flip=True)
        torch.cuda.synchronize(device)
        return img, again, out

    with ThreadPoolExecutor(1) as pool:
        got = pool.submit(run, "cuda:1").result()
    want = run("cuda:0")
    for g, w in zip(got, want):
        assert g.device == torch.device("cuda", 1)
        assert torch.equal(g.cpu(), w.cpu())
    assert torch.equal(got[2].cpu(), image.crop_resize_plain(
        [want[0].cpu()], boxes, 45, grey=True, flip=True))

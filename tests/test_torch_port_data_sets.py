"""The port's HHI datasets, loaders and fixtures against the JAX package's.

On the JAX package's own fixtures (``egot2x/data/synthetic.py``, seed 0),
each ported dataset's items (``device="cpu"``: cv2 decodes, the plain
``crop_resize``) against ``egot2x``'s:

* labels, ids, lengths, masks, audio, MFCC and bucket plans equal;
* LAM frames bit for bit where the JAX loader takes its native plane (a
  whole 7-frame window), within 2 grey levels where it leaves it for cv2
  (a window with missing frames, edge-padded; measured: 1 level on ~13%
  of the pixels);
* TTM and ASD frames, faces and grey squares within 2 levels of
  ``cv2.resize``'s (measured: 1 level on 9-13% of the pixels; ASD's
  crop augmentation, two resizes, 2 levels on up to 26%), the rotation
  within 2 of ``cv2.warpAffine``.

The challenges' test layouts (``LamTestDataset``, ``TtmTestDataset``) on
small trees written here, the same way. ``BatchLoader`` and
``BucketBatchLoader`` give the JAX package's batch order, shapes, padding
and ``drop_last`` for two epochs. The port's
fixture writers on the CPU write the JAX package's trees byte for byte.
"""

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from egot2x.data import synthetic as jsyn  # noqa: E402
from egot2x.data.asd import AsdSeqDataset as JaxAsdSeq  # noqa: E402
from egot2x.data.asd import AsdTrialDataset as JaxAsd  # noqa: E402
from egot2x.data.bucketing import BucketBatchLoader as JaxBuckets  # noqa: E402
from egot2x.data.lam import LamClipDataset as JaxLam  # noqa: E402
from egot2x.data.lam import LamSeqDataset as JaxLamSeq  # noqa: E402
from egot2x.data.lam import LamStripDataset as JaxLamStrip  # noqa: E402
from egot2x.data.pipeline import BatchLoader as JaxBatchLoader  # noqa: E402
from egot2x.data.ttm import TtmSegmentDataset as JaxTtm  # noqa: E402
from egot2x.data.ttm_2task import TtmTwoTaskDataset as JaxTtm2  # noqa: E402
from egot2x.data.ttm_2task import (  # noqa: E402
    TtmTwoTaskSeqDataset as JaxTtm2Seq)
from egot2x.translate.vocab import build_hhi_vocab  # noqa: E402
from egot2x_torch.data import synthetic  # noqa: E402
from egot2x_torch.data.asd import AsdSeqDataset, AsdTrialDataset  # noqa: E402
from egot2x_torch.data.bucketing import BucketBatchLoader  # noqa: E402
from egot2x_torch.data.lam import (LamClipDataset, LamSeqDataset,  # noqa: E402
                                   LamStripDataset)
from egot2x_torch.data.pipeline import BatchLoader  # noqa: E402
from egot2x_torch.data.ttm import TtmSegmentDataset  # noqa: E402
from egot2x_torch.data.ttm_2task import (TtmTwoTaskDataset,  # noqa: E402
                                         TtmTwoTaskSeqDataset)
from test_torch_port_train import _one_thread  # noqa: E402,F401

CV2_BAR = 2   # grey levels; tests/test_native.py's bar against cv2.resize
# the normalized frames' step: one grey level over ImageNet's least std
LEVEL = 1 / 255 / 0.224


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    d = tmp_path_factory.mktemp("fixtures")
    return {"lam": jsyn.make_lam_fixture(str(d / "lam"), img_size=32),
            "ttm": jsyn.make_ttm_fixture(str(d / "ttm"), img_size=32),
            "asd": jsyn.make_asd_fixture(str(d / "asd"), img_size=48)}


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else v


def _same_item(ours, theirs, pixels=(), exact_pixels=False):
    """Every key equal, but ``pixels`` (uint8 levels, or normalized frames
    when ``exact_pixels`` is False): within ``CV2_BAR`` levels."""
    assert list(ours) == list(theirs)
    for key, want in theirs.items():
        got = _host(ours[key])
        if key in pixels and not exact_pixels:
            step = LEVEL if want.dtype == np.float32 else 1
            assert got.shape == want.shape and got.dtype == want.dtype, key
            gap = np.abs(got.astype(np.float64) - want) / step
            assert gap.max() <= CV2_BAR + 1e-3, (key, gap.max())
        elif isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            assert got == want, key


def test_lam_clips(roots):
    """Whole windows through the JAX package's native plane: bit for bit;
    windows at a track's ends (missing frames, edge-padded) within 2."""
    theirs = JaxLam(roots["lam"], split="train", img_size=32)
    ours = LamClipDataset(roots["lam"], split="train", img_size=32,
                          device="cpu")
    assert ours.imgs == theirs.imgs and ours.kframes == theirs.kframes
    exact = 0
    for i in range(len(theirs)):
        uid, track, f = theirs.imgs[theirs.kframes[i]][:3]
        whole = all(j in theirs.img_group[uid][track]
                    for j in range(f - 3, f + 4))
        _same_item(ours[i], theirs[i], pixels=("frames",),
                   exact_pixels=whole)
        exact += whole
    assert 0 < exact < len(theirs)


def test_lam_seq_and_strips(roots, tmp_path):
    """Sequence targets; the JAX package's strips read by the port as it
    reads them, bit for bit; the port's own strips in the same layout."""
    import shutil

    vocab = build_hhi_vocab()
    _same_item(LamSeqDataset(vocab, roots["lam"], split="val",
                             device="cpu")[5],   # frame 6: a whole window
               JaxLamSeq(vocab, roots["lam"], split="val")[5],
               pixels=("frames",), exact_pixels=True)
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(roots["lam"], jax_root)
    shutil.copytree(roots["lam"], port_root)
    theirs = JaxLamStrip(jax_root, split="train", img_size=32,
                         preprocess=True)
    ours = LamStripDataset(jax_root, split="train", img_size=32,
                           device="cpu")
    for i in (0, 5):
        _same_item(ours[i], theirs[i], pixels=("frames",),
                   exact_pixels=True)
    LamStripDataset(port_root, split="train", img_size=32, preprocess=True,
                    device="cpu")
    assert sorted(os.listdir(os.path.join(port_root, "imgs_processed",
                                          "vid000"))) == sorted(
        os.listdir(os.path.join(jax_root, "imgs_processed", "vid000")))


def test_test_split_layouts(tmp_path):
    """The challenges' test layouts (no labels): LAM's per-track face
    crops of another size than ``img_size``, resized whole, 7-frame
    windows edge-padded at the track's ends; TTM's per-segment faces and
    wave, a long segment chunked."""
    import json

    import cv2
    from scipy.io import wavfile

    from egot2x.data.lam import LamTestDataset as JaxLamTest
    from egot2x.data.ttm import TtmTestDataset as JaxTtmTest
    from egot2x_torch.data.lam import LamTestDataset
    from egot2x_torch.data.ttm import TtmTestDataset

    rng = np.random.default_rng(4)
    lam = tmp_path / "lam_test" / "vid0" / "track0"
    lam.mkdir(parents=True)
    for f in (1, 2, 3, 5, 6):   # frame 4 missing
        cv2.imwrite(str(lam / f"{f}_u{f}.jpg"),
                    rng.integers(0, 255, (40, 40, 3), dtype=np.uint8))
    theirs = JaxLamTest(str(tmp_path / "lam_test"), img_size=24)
    ours = LamTestDataset(str(tmp_path / "lam_test"), img_size=24,
                          device="cpu")
    assert ours.items == theirs.items
    for i in range(len(theirs)):
        _same_item(ours[i], theirs[i], pixels=("frames",))
    seg_info = {}
    for sid, n in (("s0", 20), ("s1", 320)):
        face = tmp_path / "ttm_test" / sid / "face"
        face.mkdir(parents=True)
        (face.parent / "audio").mkdir()
        for f in range(min(n, 40)):
            cv2.imwrite(str(face / f"{f:05d}.jpg"),
                        rng.integers(0, 255, (30, 30, 3), dtype=np.uint8))
        wavfile.write(str(face.parent / "audio" / "aud.wav"), 16000,
                      (jsyn.make_wave(n * 600, seed=n) * 32767).astype(
                          np.int16))
        seg_info[sid] = {"frame_num": n, "frame_list": list(range(n))}
    with open(tmp_path / "seg_info.json", "w") as f:
        json.dump(seg_info, f)
    args = (str(tmp_path / "ttm_test"), str(tmp_path / "seg_info.json"))
    theirs = JaxTtmTest(*args, img_size=24)
    ours = TtmTestDataset(*args, img_size=24, device="cpu")
    assert ours.segments == theirs.segments
    np.testing.assert_array_equal(ours.lengths, theirs.lengths)
    for idx in range(len(theirs)):
        _same_item(ours.get_item(idx, 15), theirs.get_item(idx, 15),
                   pixels=("frames",))


@pytest.mark.parametrize("cls", ["segments", "two_task", "seq"])
def test_ttm_items(roots, cls):
    vocab = build_hhi_vocab()
    theirs, ours = {
        "segments": (JaxTtm(roots["ttm"], "train", img_size=40),
                     TtmSegmentDataset(roots["ttm"], "train", img_size=40,
                                       device="cpu")),
        "two_task": (JaxTtm2(roots["ttm"], "val", img_size=24),
                     TtmTwoTaskDataset(roots["ttm"], "val", img_size=24,
                                       device="cpu")),
        "seq": (JaxTtm2Seq(vocab, roots["ttm"], "val", img_size=16),
                TtmTwoTaskSeqDataset(vocab, roots["ttm"], "val",
                                     img_size=16, device="cpu"))}[cls]
    assert ours.segments == theirs.segments
    np.testing.assert_array_equal(ours.lengths, theirs.lengths)
    for idx, n in ((0, 15), (4, 60), (len(theirs) - 1, 30)):
        _same_item(ours.get_item(idx, n), theirs.get_item(idx, n),
                   pixels=("frames", "video_asd"))


@pytest.mark.parametrize("split", ["train", "val"])
def test_asd_items(roots, split):
    """Train items augment (audio overlay, flip / crop / rotate from the
    item's generator): the draws, labels and MFCC equal, the faces within
    2 of cv2's."""
    vocab = build_hhi_vocab()
    theirs = JaxAsdSeq(vocab, roots["asd"], split, with_rgb=True,
                       rgb_size=32)
    ours = AsdSeqDataset(vocab, roots["asd"], split, with_rgb=True,
                         rgb_size=32, device="cpu")
    np.testing.assert_array_equal(ours.lengths, theirs.lengths)
    for idx in range(len(theirs)):
        _same_item(ours.get_item(idx, 15), theirs.get_item(idx, 15),
                   pixels=("faces", "frames"))
    plain = AsdTrialDataset(roots["asd"], split, device="cpu")
    _same_item(plain.get_item(1, 30), JaxAsd(roots["asd"], split).get_item(
        1, 30), pixels=("faces",))


def _order(loader, key):
    out = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        out.append([(tuple(b[key]), tuple(np.shape(_host(b["frames"]))),
                     tuple(b.get("valid", ()))) for b in loader])
    return out


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_batch_loader_order(roots, mode):
    theirs = JaxLam(roots["lam"], split="train", img_size=16)
    ours = LamClipDataset(roots["lam"], split="train", img_size=16,
                          device="cpu")
    kw = dict(mode=mode, seed=3, num_workers=2)
    jl, pl = JaxBatchLoader(theirs, 5, process_index=0, process_count=1,
                            **kw), BatchLoader(ours, 5, **kw)
    assert len(pl) == len(jl)
    assert _order(pl, "uid") == _order(jl, "uid")


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_bucket_loader_plan(roots, mode):
    """Buckets, batch sizes from the frames budget, the shuffled plan, the
    wrap-repeat of a bucket smaller than a batch, eval padding."""
    theirs = JaxTtm(roots["ttm"], "train", img_size=16)
    ours = TtmSegmentDataset(roots["ttm"], "train", img_size=16, device="cpu")
    kw = dict(frames_budget=60, buckets=(15, 30, 60), mode=mode, seed=1,
              num_workers=2)
    jl, pl = JaxBuckets(theirs, **kw), BucketBatchLoader(ours, **kw)
    assert len(pl) == len(jl)
    assert _order(pl, "seg_id") == _order(jl, "seg_id")


@pytest.mark.parametrize("task", ["lam", "ttm", "asd"])
def test_fixture_writers_match_the_jax_packages(tmp_path, task):
    """The same tree, file for file, byte for byte (cv2 writes both)."""
    kw = dict(img_size=16) if task != "asd" else dict(img_size=24)
    if task == "ttm":
        kw["seg_lens"] = [16, 20]
    ours = getattr(synthetic, f"make_{task}_fixture")(
        str(tmp_path / "ours"), device="cpu", **kw)
    theirs = getattr(jsyn, f"make_{task}_fixture")(str(tmp_path / "theirs"),
                                                  **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), theirs)
                   for d, _, fs in os.walk(theirs) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), ours)
                           for d, _, fs in os.walk(ours) for f in fs)
    match, mismatch, errors = filecmp.cmpfiles(theirs, ours, files,
                                               shallow=False)
    assert not mismatch and not errors

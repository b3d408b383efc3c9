"""The port's PNR/OSCC Stage-I models and metrics against the JAX package.

``egot2x_torch`` ``KeyframeLocalizationResNet``, ``StateChangeClsResNet``,
``DualHeadResNet`` and ``KeyframeCnnLSTM`` (``models/pnr.py``) against
``egot2x.models.pnr``'s, built by each package's ``build_model`` at full
width and depth (ResNet3D-50 ``slow_layer5``) on 2 clips of 4 raw uint8
frames at crop 65, where the head's 2x2 pool gives 8192-d tokens as at
crop 225; ``KeyframeCnnLSTM`` at 64^2, its stem on the plain version (the
CPU path of ``ops/stem.py::stem_pool_2d``). The keyframe model runs a
``dot_product`` Nonlocal after res3 and res4 block 1
(``resolve_nonlocal([[[]], [[1]], [[1]], [[]]])``, as ``chip_smoke.py``'s
hoi phase does). Weights: ``random_jax_variables`` through the bridge,
with the statistics of the stems' BNs and of the Nonlocals' BNs set from a
calibration batch by precise BN (tests/test_torch_port_resnet3d.py says
why). f32 on the CPU, the JAX side jitted once a model, its trunk traced
once for the outputs of one jit (``trunks_traced_once``).

Tolerances: logits and scores max |delta| <= 1e-4 (1 + |ref|); the
8192-d tokens within 1e-4 of their norm per frame (and elementwise at the
logits' bar). The PNR metrics equal ``egot2x.metrics.pnr``'s on the same
arrays. ``quant=True`` raises by name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import egot2x.models.pnr  # noqa: E402,F401
from egot2x.core.registry import build_model as jax_build  # noqa: E402
from egot2x.metrics import pnr as jax_metrics  # noqa: E402
from egot2x.nn.resnet3d import resolve_nonlocal as jax_nonlocal  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.registry import build_model  # noqa: E402
from egot2x_torch.metrics import pnr as metrics  # noqa: E402
from egot2x_torch.nn.resnet3d import Nonlocal, resolve_nonlocal  # noqa: E402
from egot2x_torch.train.precise_bn import (  # noqa: E402
    compute_precise_bn_stats)
from test_torch_port_resnet3d import assert_close  # noqa: E402
from test_torch_port_train import (_one_thread,  # noqa: E402,F401
                                   trunks_traced_once)

B, T, CROP, LSTM_IMG = 2, 4, 65, 64
SEED = 4
NONLOCAL = [[[]], [[1]], [[1]], [[]]]


def _frames(seed, img=CROP):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (B, T, img, img, 3)).astype(np.uint8)


def _calibrated(model, frames):
    """The bridge's seeded weights, the stem's BN statistics and the
    dot_product Nonlocals' fitted to ``frames``; the JAX tree of it."""
    bridge.load_jax_variables(model, bridge.random_jax_variables(model, SEED))
    stem = (model.backbone.bn1 if hasattr(model, "backbone")
            else model.trunk.s1.bn)
    bns = [stem] + [m.bn for m in model.modules() if isinstance(m, Nonlocal)]
    compute_precise_bn_stats(model, [(frames,)], 1, bns=bns)
    return bridge.to_jax_variables(model)


def _pair(name, img=CROP, **kw):
    """(port model, JAX model, JAX variables) of ``name``."""
    jax_kw = dict(kw)
    if "nonlocal_cfg" in kw:
        kw["nonlocal_cfg"] = resolve_nonlocal(kw["nonlocal_cfg"])
        jax_kw["nonlocal_cfg"] = jax_nonlocal(jax_kw["nonlocal_cfg"])
    port = build_model(name, device="cpu", **kw)
    calib = torch.from_numpy(_frames(9, img))
    if name == "KeyframeCnnLSTM":
        calib = calib.float()   # raw pixels, as the PNR pipeline feeds
    return port, jax_build(name, **jax_kw), _calibrated(port, calib)


@pytest.fixture(scope="module")
def keyframe():
    port, jm, v = _pair("KeyframeLocalizationResNet", crop_size=CROP,
                        nonlocal_cfg=NONLOCAL)
    x = _frames(1)
    want = jax.jit(trunks_traced_once(
        lambda v, f: (jm.apply(v, f), jm.apply(v, f, middle=True)),
        ("trunk",)))(v, jnp.asarray(x))
    with torch.no_grad():
        got = (port(torch.from_numpy(x)),
               port(torch.from_numpy(x), middle=True))
    return [t.numpy() for t in got], [np.asarray(w) for w in want]


@pytest.fixture(scope="module")
def state_change():
    """Both temporal-pool settings on one weight tree (their heads have
    the same shape), and the tokens."""
    port, jm, v = _pair("StateChangeClsResNet", crop_size=CROP)
    port_np = build_model("StateChangeClsResNet", device="cpu",
                          crop_size=CROP, no_temp_pool=True)
    port_np.load_state_dict(port.state_dict())
    jm_np = jax_build("StateChangeClsResNet", crop_size=CROP,
                      no_temp_pool=True)
    x = _frames(2)
    want = jax.jit(trunks_traced_once(
        lambda v, f: (jm.apply(v, f), jm_np.apply(v, f),
                      jm.apply(v, f, middle=True),
                      jm_np.apply(v, f, middle=True)), ("trunk",)))(
        v, jnp.asarray(x))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = (port(xt), port_np(xt), port(xt, middle=True),
               port_np(xt, middle=True))
    return [t.numpy() for t in got], [np.asarray(w) for w in want]


def test_keyframe_logits_and_tokens_match_jax(keyframe):
    (logits, tokens), (want, want_tokens) = keyframe
    assert logits.shape == (B, T, 1) and tokens.shape == (B, T, 8192)
    assert np.isfinite(logits).all() and np.isfinite(tokens).all()
    assert_close(logits, want)
    assert_close(tokens, want_tokens)
    err = np.linalg.norm(tokens - want_tokens, axis=-1)
    assert (err <= 1e-4 * np.linalg.norm(want_tokens, axis=-1)).all()


@pytest.mark.parametrize("case", ["temporal_pool", "no_temp_pool"])
def test_state_change_matches_jax(state_change, case):
    got, want = state_change
    k = 0 if case == "temporal_pool" else 1
    assert got[k].shape == (B, 2)
    assert_close(got[k], want[k])
    # tokens: one position after the full pool, one a frame without it
    assert got[k + 2].shape == (B, 1 if k == 0 else T, 8192)
    assert_close(got[k + 2], want[k + 2])


def test_dual_head_matches_jax():
    port, jm, v = _pair("DualHeadResNet", crop_size=CROP)
    x = _frames(3)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got[0].shape == (B, T) and got[1].shape == (B, 2)
    for g, w in zip(got, want):
        assert_close(g.numpy(), np.asarray(w))


def test_cnn_lstm_matches_jax():
    """Raw float pixels, as the PNR pipeline feeds them (the 2D trunk
    takes float frames as they are)."""
    port, jm, v = _pair("KeyframeCnnLSTM", img=LSTM_IMG)
    x = _frames(4, LSTM_IMG).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (B, T)
    assert 0.02 < got.min() and got.max() < 0.98   # not saturated
    assert_close(got, want)


def test_pnr_metrics_match_jax():
    rng = np.random.default_rng(6)
    n = 32
    preds = rng.standard_normal((n, 16)).astype(np.float32)
    labels = np.eye(16, dtype=np.float32)[rng.integers(0, 16, n)]
    labels[:8] = np.eye(16, dtype=np.float32)[np.argmax(preds[:8], axis=1)]
    state = rng.integers(0, 2, n)
    fps = rng.uniform(2, 30, n)
    start = rng.integers(0, 100, n)
    end = start + rng.integers(16, 300, n)
    pnr = start + rng.integers(0, 16, n)
    args = (preds, state, fps, start, end, pnr)
    assert metrics.keyframe_distance(*args) == pytest.approx(
        jax_metrics.keyframe_distance(*args), rel=1e-12)
    assert metrics.keyframe_distance(*args)[1] == int(state.sum())
    assert (metrics.keyframe_accuracy(preds, labels, state)
            == jax_metrics.keyframe_accuracy(preds, labels, state))
    logits = rng.standard_normal((n, 2))
    assert (metrics.state_change_accuracy(logits, state)
            == jax_metrics.state_change_accuracy(logits, state))


@pytest.mark.parametrize("name", ["KeyframeLocalizationResNet",
                                  "StateChangeClsResNet"])
def test_quant_raises_by_name(name):
    with pytest.raises(NotImplementedError, match="QuantConv3D"):
        build_model(name, device="cpu", quant=True)

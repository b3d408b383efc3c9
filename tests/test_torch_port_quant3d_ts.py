"""ts_pnr with int8 trunks (``TaskFusionMFTransformer3TaskDropout``,
``quant=True``) against the JAX package's, f32.

The JAX package's own int8 gate geometry (tests/test_quant_3d.py:66-116)
but for the batch: the three frozen trunks at full width and depth (two
ResNet3D-50s, the SlowFast-R50), 4 raw uint8 PNR frames at crop 65, uint8
pathways of 2 slow and 8 fast frames at 64^2, alpha 4, beta_inv 8, D 64,
1 layer; ``target="keyframe"`` (ts_pnr's head, 16 logits); 1 clip, not
2: the JAX side's int8 convs keep an 8-core CPU busy ~3 s a clip, beside
the test suite's other workers. Weights:
``random_jax_variables`` through the bridge, the PNR and OSCC stems' BN
statistics fitted to a calibration batch by precise BN (their stems alone:
they stay float), then the port's ``calibrate`` on the served batch; the
JAX model takes those scales through the bridge's ``quant`` collection
(tests/test_torch_port_quant3d_trunks.py holds the port's calibration to
JAX's). The JAX side is jitted and teacher-forced: each of its 208
``QuantConv3D`` is fed the input the port's conv at the same path took
(that file's docstring says why: free-running, a quantum flipped by the
packages' different f32 rounding moves what follows it, and the two
translators' logits read cosine 0.99977 at 2 clips).

Tolerances (``assert_forced_match``): each int8 conv's output within
rtol 1e-6 of JAX's and the input JAX computed itself within 1e-4 (1 + |x|)
of the port's on all but 2% of the elements (measured at most 0.17% and
0.09%: inputs a quantum apart where XLA reorders the quantizer's divide),
each output at cosine > 0.9999 (measured 1 - 8e-9 at worst); logits
within 1e-4 (1 + |logit|) and at cosine > 0.9999 (measured max |diff|
6.0e-7 of logits up to 1.8, cosine 1 - 5e-14); the int8 SlowFast-R50's
two res5 maps at cosine > 0.9999 (held here at its one width, the JAX
module's, which no model changes; measured 1 - 4e-15, max |diff| 1.4e-6
of maps up to 8.3). The port's int8 logits against its float ones:
cosine > 0.99 and equal argmax, the JAX package's gate
(tests/test_quant_3d.py:113-116). The refusals: an uncalibrated forward,
``quant=True`` on a translator whose JAX ``__call__`` takes no
``calibrate``, and on the AR SlowFast models, whose JAX classes have no
``quant``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import egot2x.translate.egot2s_hoi  # noqa: E402,F401
from egot2x.core.registry import build_model as jax_build  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.registry import build_model  # noqa: E402
from egot2x_torch.nn.quant import calibrate  # noqa: E402
from egot2x_torch.train.precise_bn import (  # noqa: E402
    compute_precise_bn_stats)
from test_torch_port_quant3d_trunks import (  # noqa: E402
    assert_forced_match, cosine, forced_apply, nthwc, port_int8_run)
from test_torch_port_train import _one_thread  # noqa: E402,F401

B, T, CROP, T_FAST, IMG, ALPHA = 1, 4, 65, 8, 64, 4   # 1 clip: see above
NAME = "TaskFusionMFTransformer3TaskDropout"
KW = dict(target="keyframe", feature_dim=64, num_layers=1, crop_size=CROP,
          alpha=ALPHA, beta_inv=8)
PORT_KW = dict(pnr_frames=T, action_frames=T_FAST)
SEED = 13
LOGIT_TOL, COSINE, GATE = 1e-4, 0.9999, 0.99


def inputs(seed):
    """uint8 frames (B, T, 65, 65, 3) and pathways [(B, 2, 64, 64, 3),
    (B, 8, 64, 64, 3)], as numpy."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (B, T, CROP, CROP, 3)).astype(np.uint8)
    paths = [rng.integers(0, 256, (B, t, IMG, IMG, 3)).astype(np.uint8)
             for t in (T_FAST // ALPHA, T_FAST)]
    return frames, paths


def ts_run(dtype):
    """The port's int8 ts_pnr in ``dtype``, seeded, stem BNs fitted,
    calibrated, run on the served batch (logits and each int8 conv's
    input and output), and the teacher-forced JAX twin's."""
    model = build_model(NAME, device="cpu", quant=True, dtype=dtype,
                        **KW, **PORT_KW)
    bridge.load_jax_variables(model, bridge.random_jax_variables(model, SEED))
    cal, _ = inputs(SEED + 1)
    for trunk in (model.pnr_model.trunk, model.oscc_model.trunk):
        compute_precise_bn_stats(trunk.s1, [(torch.from_numpy(cal),)], 1,
                                 bns=[trunk.s1.bn])
    frames, paths = inputs(SEED + 2)
    feed = (torch.from_numpy(frames), [torch.from_numpy(p) for p in paths])
    calibrate(model, *feed)
    maps = []
    hook = model.action_model.register_forward_hook(
        lambda mod, i, o: maps.extend(nthwc(m) for m in o))
    try:
        got, seen = port_int8_run(model, *feed)
    finally:
        hook.remove()
    jax_dtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jm = jax_build(NAME, quant=True, dtype=jax_dtype, **KW)
    want, jax_seen, recorded = forced_apply(jm.apply, ("action_model",))(
        bridge.to_jax_variables(model), seen, jnp.asarray(frames),
        [jnp.asarray(p) for p in paths])
    return dict(model=model, feed=feed, got=got, seen=seen, want=want,
                jax_seen=jax_seen, maps=maps,
                want_maps=recorded["action_model"])


@pytest.fixture(scope="module")
def f32():
    return ts_run(torch.float32)


def test_ts_pnr_int8_matches_jax(f32):
    got, want = f32["got"].numpy(), np.asarray(f32["want"])
    assert got.shape == want.shape == (B, 16) and np.isfinite(got).all()
    assert len(f32["seen"]) == 208   # 52 a ResNet3D-50, 104 SlowFast
    assert_forced_match(f32["seen"], f32["jax_seen"])
    assert (np.abs(got - want) <= LOGIT_TOL * (1 + np.abs(want))).all()
    assert cosine(got, want) > COSINE
    # the int8 SlowFast-R50's res5 maps, slow and fast
    for g, w, c in zip(f32["maps"], f32["want_maps"], (2048, 256)):
        assert g.shape == np.shape(w) and g.shape[-1] == c
        assert cosine(g, w) > COSINE


def test_int8_tracks_float(f32):
    """The float logits are the calibration pass's (the float path end to
    end, as in the JAX package's ``calibrate=True``), on the batch the
    scales came from: its maxima are recorded again, unchanged."""
    flagged = [m for m in f32["model"].modules()
               if hasattr(m, "calibrating")]
    for m in flagged:
        m.calibrating = True
    try:
        with torch.no_grad():
            want = f32["model"](*f32["feed"]).numpy()
    finally:
        for m in flagged:
            m.calibrating = False
    got = f32["got"].numpy()
    assert cosine(got, want) > GATE
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_int8_refusals():
    model = build_model(NAME, device="cpu", quant=True, **KW, **PORT_KW)
    frames, paths = inputs(0)
    with pytest.raises(ValueError, match="uncalibrated"):
        model(torch.from_numpy(frames), [torch.from_numpy(p) for p in paths])
    with pytest.raises(ValueError, match="Keyframe2State: no int8 path"):
        build_model("Keyframe2State", device="cpu", quant=True)
    for name in ("MultiTaskSlowFast", "SlowFastFeature"):
        with pytest.raises(TypeError, match="quant"):
            build_model(name, device="cpu", quant=True)

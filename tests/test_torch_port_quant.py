"""The port's int8 static-PTQ path against the JAX package.

Weights are one numpy variable tree per model (``bridge.random_jax_variables``
of the port's quant model, JAX layout) that both packages load; the
activation scales are JAX's own (``calibrate_variables``), carried into
the port through the weight bridge's ``quant`` collection, unless a test
says otherwise. Inputs are drawn with numpy from a seed. The JAX side is
jitted, as it deploys.

Tolerances and why:
  * the int8 accumulator is exact integer arithmetic on both sides:
    equal bit for bit; its dequantized output is the same f32 products:
    rtol 1e-6;
  * scales calibrated by the port vs by ``egot2x``: max-abs of the same
    f32 activations, which differ only by summation order: rtol 1e-5;
  * int8 modules and the flagship in f32 compute: the f32 convs around
    the int8 ones sum in another order, so a value within one rounding of
    a quantization boundary flips by one quantum and moves what follows
    it. The bar is logit or feature cosine > 0.9999 (the measured max
    |diff| is in each test); in bf16 compute cosine > 0.999, the JAX
    package's own bar for one quantum of stem flips under bf16
    (tests/test_fused_stem.py:63).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import egot2x.translate.egot2s_hhi  # noqa: E402,F401
from egot2x.core.registry import build_model as jax_build  # noqa: E402
from egot2x.nn.quant import QuantConv, calibrate_variables  # noqa: E402
from egot2x.nn.resnet2d import ResNet2D as JaxResNet2D  # noqa: E402
from egot2x.nn.talknet import TalkNetModel as JaxTalkNet  # noqa: E402
from egot2x_torch.core import bridge  # noqa: E402
from egot2x_torch.core.registry import build_model  # noqa: E402
from egot2x_torch.nn.quant import (QuantConv2d, calibrate,  # noqa: E402
                                   quantize_weight, scale_buffers)
from egot2x_torch.nn.resnet2d import ResNet2D  # noqa: E402
from egot2x_torch.nn.talknet import TalkNetModel  # noqa: E402
from egot2x_torch.ops.int8 import conv2d_int8  # noqa: E402
from test_torch_port_train import _one_thread  # noqa: E402,F401

D, HEADS, LAYERS = 32, 4, 1
B, T, IMG, GREY = 2, 4, 32, 48
KW = dict(hidden_dim=D, num_heads=HEADS, num_layers=LAYERS)


def _cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _shapes(tree):
    return {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _flagship_inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, IMG, IMG, 3)).astype(np.float32),
            rng.uniform(0, 255, (B, T, GREY, GREY)).astype(np.float32),
            np.zeros((B, T * 16000 // 30), np.float32),
            rng.standard_normal((B, 4 * T, 13)).astype(np.float32)]


def _torch(args):
    return [torch.from_numpy(a) for a in args]


_SEEDED = {}


def _seeded(port, seed):
    """``bridge.random_jax_variables(port, seed)``, drawn once per seed and
    tree (the int8 flagships of either dtype or stem layout share theirs:
    a draw reads only the tree's shapes, ~4 s for the flagship's trunks).
    Nothing mutates the arrays it returns."""
    key = (seed, tuple((k, tuple(v.shape))
                       for k, v in port.state_dict().items()))
    if key not in _SEEDED:
        _SEEDED[key] = bridge.random_jax_variables(port, seed)
    return dict(_SEEDED[key])


def _port_flagship(dtype=torch.float32, fuse_stems=True):
    return build_model("TaskFusionMFTransformer3Task", device="cpu",
                       quant=True, fuse_stems=fuse_stems, dtype=dtype, **KW)


@pytest.fixture(scope="module")
def flagship():
    """(JAX model, port model, variables with JAX-calibrated scales,
    inputs), f32 compute, ``fuse_stems=True`` on both sides."""
    model = jax_build("TaskFusionMFTransformer3Task", quant=True,
                      fuse_stems=True, **KW)
    port = _port_flagship()
    variables = _seeded(port, 1)
    x = _flagship_inputs(0)
    variables = calibrate_variables(model, variables, *map(jnp.asarray, x),
                                    train=False)
    bridge.load_jax_variables(port, variables)
    return model, port, variables, x


def _jax_logits(model, variables, x):
    fn = jax.jit(lambda v, *a: model.apply(v, *a, train=False))
    return np.asarray(fn(variables, *map(jnp.asarray, x)), np.float32)


def test_quantize_weight_matches_jax():
    """Per output channel over (C_in, kh, kw), bit for bit."""
    k = (np.random.default_rng(0).standard_normal((3, 3, 16, 24)) * 0.1
         ).astype(np.float32)
    s_w = jnp.maximum(jnp.max(jnp.abs(k), axis=(0, 1, 2)), 1e-12) / 127.0
    wq = jnp.round(k / s_w).astype(jnp.int8)
    got_wq, got_s = quantize_weight(torch.from_numpy(k.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(s_w))
    np.testing.assert_array_equal(got_wq.numpy(),
                                  np.asarray(wq).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("k, stride, int8_in", [
    (3, 1, True), (3, 2, True), (1, 2, True), (3, 1, False)])
def test_quant_conv_matches_jax(k, stride, int8_in):
    """The int32 accumulator equals JAX's; the dequantized output matches
    ``QuantConv`` to f32 rounding, fed int8 at ``in_scale`` or a float
    input that it quantizes with its own ``act_max``."""
    rng = np.random.default_rng(k * 10 + stride)
    c, o, hw = 16, 24, 9
    kernel = (rng.standard_normal((k, k, c, o)) * 0.1).astype(np.float32)
    act_max, in_scale = np.float32(3.0), np.float32(0.02)
    if int8_in:
        x = rng.integers(-127, 128, (2, hw, hw, c), dtype=np.int8)
    else:
        x = (rng.standard_normal((2, hw, hw, c)) * 2).astype(np.float32)
    pad = [(k // 2, k // 2)] * 2
    jax_conv = QuantConv(o, (k, k), strides=(stride, stride), padding=pad)
    want = jax_conv.apply(
        {"params": {"kernel": kernel}, "quant": {"act_max": act_max}},
        jnp.asarray(x), in_scale=jnp.float32(in_scale) if int8_in else None)

    conv = QuantConv2d(c, o, k, stride, k // 2)
    conv.load_state_dict({"weight": torch.from_numpy(
        kernel.transpose(3, 2, 0, 1)), "act_max": torch.tensor(act_max)})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = conv(xt, torch.tensor(in_scale) if int8_in else None)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-6, atol=0)

    if int8_in:   # the accumulator itself, against XLA's int32 conv
        s_w = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 2)),
                          1e-12) / 127.0
        acc = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.round(kernel / s_w).astype(jnp.int8),
            (stride, stride), pad, dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        wq, _ = conv.int8_weight()
        ours = conv2d_int8(xt, wq, stride, k // 2)
        np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(acc))


def _shared_calibrated(jax_model, port, seed, *inputs):
    variables = bridge.random_jax_variables(port, seed)
    variables = calibrate_variables(jax_model, variables,
                                    *map(jnp.asarray, inputs))
    bridge.load_jax_variables(port, variables)
    return port.eval(), variables


def test_resnet2d_int8_matches_jax():
    """Single trunk, its own int8 stem (n = 1), 3 frames of 48^2. Measured
    max |diff| 1.8e-6 of features up to 4.1."""
    x = np.random.default_rng(2).standard_normal((3, 48, 48, 3)).astype(
        np.float32)
    jax_model = JaxResNet2D(num_classes=256, quant=True)
    port, variables = _shared_calibrated(
        jax_model, ResNet2D(256, quant=True), 2, x)
    ours = np.asarray(jax.jit(jax_model.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        theirs = port(torch.from_numpy(x)).numpy()
    assert theirs.shape == (3, 256)
    assert _cosine(theirs, ours) > 0.9999


def test_talknet_int8_matches_jax():
    """The int8 visual ResNet (3D stem, AVSR layers, int8 chained) with
    the float audio encoder and attention; two clips of 4 frames of 48^2.
    Measured max |diff| 2.4e-5 of outputs up to 4.8."""
    rng = np.random.default_rng(3)
    mfcc = rng.standard_normal((2, 16, 13)).astype(np.float32)
    faces = rng.uniform(0, 255, (2, 4, GREY, GREY)).astype(np.float32)
    jax_model = JaxTalkNet(quant=True)
    port, variables = _shared_calibrated(
        jax_model, TalkNetModel(quant=True), 3, mfcc, faces)
    ours = jax.jit(jax_model.apply)(variables, jnp.asarray(mfcc),
                                    jnp.asarray(faces))
    with torch.no_grad():
        theirs = port(torch.from_numpy(mfcc), torch.from_numpy(faces))
    for a, b, d in zip(theirs, ours, (256, 128, 128)):
        assert a.shape == (2, 4, d)
        assert _cosine(a.numpy(), b) > 0.9999


def test_calibrate_reproduces_jax_scales(flagship):
    """The port's ``calibrate`` on the same weights and batch records the
    scales ``calibrate_variables`` does, every one of them."""
    _, _, variables, x = flagship
    port = _port_flagship()
    bridge.load_jax_variables(port, _seeded(port, 1))
    assert all(float(b) == 0 for _, b in scale_buffers(port))
    calibrate(port, *_torch(x))
    got = _leaves(bridge.to_jax_variables(port)["quant"])
    want = _leaves(variables["quant"])
    assert sorted(got) == sorted(want) and len(got) == 2 * 27 + 23
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)


def test_flagship_int8_f32_matches_jax(flagship):
    """Measured max |diff| 1.2e-3 of logits up to 1.9 (cosine 0.9999998):
    stem values that flip by one quantum between the two fused stems."""
    model, port, variables, x = flagship
    ours = _jax_logits(model, variables, x)
    with torch.no_grad():
        theirs = port(*_torch(x)).numpy()
    assert theirs.shape == ours.shape == (B, 2)
    assert _cosine(theirs, ours) > 0.9999


def test_flagship_int8_bf16_matches_jax():
    """bf16 compute on both sides, each calibrated in bf16 by ``egot2x``.
    Measured max |diff| 2.0e-2 of logits up to 1.9, cosine 0.99997 (bf16
    keeps 8 bits)."""
    model = jax_build("TaskFusionMFTransformer3Task", quant=True,
                      fuse_stems=True, dtype=jnp.bfloat16, **KW)
    port = _port_flagship(torch.bfloat16)
    x = _flagship_inputs(0)
    variables = calibrate_variables(
        model, _seeded(port, 1),
        *map(jnp.asarray, x), train=False)
    bridge.load_jax_variables(port, variables)
    ours = _jax_logits(model, variables, x)
    with torch.no_grad():
        theirs = port(*_torch(x))
    assert theirs.dtype == torch.bfloat16
    assert _cosine(theirs.float().numpy(), ours) > 0.999


def test_quant_bridge_round_trip_and_structure(flagship):
    """port -> JAX tree -> port is exact, the ``quant`` collection
    included, and the tree has the JAX model's structure."""
    model, port, variables, x = flagship
    init = jax.eval_shape(
        lambda *a: model.init(jax.random.key(0), *a, train=False),
        *map(jnp.asarray, x))
    back = bridge.to_jax_variables(port)
    for coll in ("params", "batch_stats", "quant"):
        assert _shapes(back[coll]) == _shapes(init[coll])
        want = _leaves(variables[coll])
        for key, leaf in _leaves(back[coll]).items():
            np.testing.assert_array_equal(leaf, want[key], err_msg=key)


def test_quant_model_draws_the_float_models_weights():
    """``random_jax_variables`` leaves scales at 0 and spends no draw on
    them: a quant model and a float model get the same weights."""
    quant = bridge.random_jax_variables(_port_flagship(), seed=7)
    flt = bridge.random_jax_variables(
        build_model("TaskFusionMFTransformer3Task", device="cpu", **KW), 7)
    assert "quant" not in flt
    assert all(v == 0 for v in _leaves(quant["quant"]).values())
    for coll in ("params", "batch_stats"):
        got, want = _leaves(quant[coll]), _leaves(flt[coll])
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_uncalibrated_quant_forward_raises():
    port = _port_flagship()
    bridge.load_jax_variables(port, _seeded(port, 1))
    with pytest.raises(ValueError, match="uncalibrated"), torch.no_grad():
        port(*_torch(_flagship_inputs(0)))


def test_int8_weight_cache_refreshes_on_load():
    """Weights are quantized once, and again after ``load_state_dict``."""
    rng = np.random.default_rng(8)
    conv = QuantConv2d(8, 16, 3, 1, 1)
    conv.act_max.fill_(2.0)
    x = torch.from_numpy(rng.standard_normal((1, 8, 6, 6)).astype(np.float32))
    with torch.no_grad():
        first = conv(x)
        cached = conv.int8_weight()[0]
        assert conv.int8_weight()[0] is cached      # not re-quantized
        state = {"weight": torch.from_numpy(
            rng.standard_normal((16, 8, 3, 3)).astype(np.float32)),
            "act_max": torch.tensor(2.0)}
        conv.load_state_dict(state)
        after = conv(x)
        fresh = QuantConv2d(8, 16, 3, 1, 1)
        fresh.load_state_dict(state)
        torch.testing.assert_close(after, fresh(x), rtol=0, atol=0)
    assert not torch.equal(after, first)
    assert conv.int8_weight()[0] is not cached


def test_fuse_stems_inert_at_calibration(flagship):
    """Calibration runs the separate float stems whatever ``fuse_stems``
    says, so both models record the same scales; the fused int8 stem then
    gives the separate stems' logits (within the JAX package's fused-stem
    bar, tests/test_fused_stem.py:63)."""
    _, fused, _, x = flagship
    separate = _port_flagship(fuse_stems=False)
    bridge.load_jax_variables(separate, _seeded(fused, 1))
    calibrate(separate, *_torch(x))
    recal = _port_flagship()
    bridge.load_jax_variables(recal, _seeded(fused, 1))
    calibrate(recal, *_torch(x))
    for (name, a), (_, b) in zip(scale_buffers(separate),
                                 scale_buffers(recal)):
        assert float(a) == float(b), name
    with torch.no_grad():
        want = separate(*_torch(x)).numpy()
        got = recal(*_torch(x)).numpy()
    assert _cosine(got, want) > 0.999
